// faceformer_tpu_torch host geometry kernel.
//
// Host-side hot ops behind the data pipeline and eval post-processing,
// exposed through a C ABI for ctypes (no pybind11 dependency):
//   - resample_edges: ragged polylines -> fixed (L, P, 2) float32 grids
//     (the per-sample packing loop, reference data.py:11-28 semantics)
//   - check_faces_enclosed: batch face-loop chaining predicate
//     (reference check_faces_enclosed.py:18-46 semantics, incl. loop splits)
//
// Ragged inputs use the flat-buffer + offsets convention:
//   points:  (total_points, 2) float64
//   offsets: (num_edges + 1,) int64 -- edge i spans points[offsets[i]:offsets[i+1])
//
// Build: faceformer_tpu_torch/ops/_build.py, at first use (g++ -O3 -shared -fPIC)

#include <cmath>
#include <cstdint>

extern "C" {

// Resample each polyline to exactly num_samples points:
// 2-point lines are linearly interpolated; longer polylines are subsampled
// at round(linspace(0, n-1, num_samples)) indices (NOT arc length).
// out has room for num_edges * num_samples * 2 floats.
void resample_edges(const double* points, const int64_t* offsets,
                    int64_t num_edges, int64_t num_samples, float* out) {
  for (int64_t e = 0; e < num_edges; ++e) {
    const double* pts = points + 2 * offsets[e];
    const int64_t n = offsets[e + 1] - offsets[e];
    float* dst = out + e * num_samples * 2;
    if (n == 2) {
      const double x1 = pts[0], y1 = pts[1], x2 = pts[2], y2 = pts[3];
      for (int64_t s = 0; s < num_samples; ++s) {
        const double t = (num_samples > 1)
            ? static_cast<double>(s) / static_cast<double>(num_samples - 1)
            : 0.0;
        dst[2 * s] = static_cast<float>(x1 + (x2 - x1) * t);
        dst[2 * s + 1] = static_cast<float>(y1 + (y2 - y1) * t);
      }
    } else {
      for (int64_t s = 0; s < num_samples; ++s) {
        const double frac = (num_samples > 1)
            ? static_cast<double>(s) * static_cast<double>(n - 1) /
                  static_cast<double>(num_samples - 1)
            : 0.0;
        // numpy .round(): banker's rounding (round-half-even)
        double idx_d = std::nearbyint(frac);
        int64_t idx = static_cast<int64_t>(idx_d);
        if (idx >= n) idx = n - 1;
        if (idx < 0) idx = 0;
        dst[2 * s] = static_cast<float>(pts[2 * idx]);
        dst[2 * s + 1] = static_cast<float>(pts[2 * idx + 1]);
      }
    }
  }
}

// Batch face-enclosedness: walk each face's edge indices; edges chain
// end-to-start within an absolute per-axis tolerance; a loop closes when
// the chain returns to its first edge's start.
//
// faces:        flat edge-index buffer
// face_offsets: (num_faces + 1,) spans into faces
// enclosed:     (num_faces,) out -> 1 if the face decomposes into loops
// loop_ends:    flat out buffer sized like faces; for enclosed faces,
//               positions (relative to the face start, counting only USED
//               indices) after which a loop closes
// num_loops:    (num_faces,) out -> number of loops (0 when not enclosed)
void check_faces_enclosed(const double* points, const int64_t* offsets,
                          int64_t num_edges, const int64_t* faces,
                          const int64_t* face_offsets, int64_t num_faces,
                          double tol, uint8_t* enclosed, int64_t* loop_ends,
                          int64_t* num_loops) {
  for (int64_t f = 0; f < num_faces; ++f) {
    const int64_t begin = face_offsets[f], end = face_offsets[f + 1];
    enclosed[f] = 1;
    num_loops[f] = 0;
    bool open = false;        // a loop is currently open
    double sx = 0, sy = 0;    // open loop's start point
    double lx = 0, ly = 0;    // previous edge's end point
    int64_t used = 0;
    for (int64_t k = begin; k < end; ++k) {
      const int64_t ind = faces[k];
      if (ind < 0 || ind >= num_edges) continue;  // skip hallucinated ids
      const double* pts = points + 2 * offsets[ind];
      const int64_t n = offsets[ind + 1] - offsets[ind];
      const double ax = pts[0], ay = pts[1];
      const double bx = pts[2 * (n - 1)], by = pts[2 * (n - 1) + 1];
      if (!open) {
        open = true;
        sx = ax;
        sy = ay;
      } else if (std::fabs(lx - ax) >= tol || std::fabs(ly - ay) >= tol) {
        enclosed[f] = 0;
        num_loops[f] = 0;
        break;
      }
      lx = bx;
      ly = by;
      ++used;
      if (std::fabs(bx - sx) < tol && std::fabs(by - sy) < tol) {
        loop_ends[face_offsets[f] + num_loops[f]] = used;
        ++num_loops[f];
        open = false;
      }
    }
    if (enclosed[f] && open) {  // unclosed tail
      enclosed[f] = 0;
      num_loops[f] = 0;
    }
  }
}

}  // extern "C"
