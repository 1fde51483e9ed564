"""Dependency-free SVG wireframe rendering (+ optional PNG rasterization).

A copy of faceformer_tpu/tools/svg.py with its imports renamed to
the port's modules: the same inputs write the same files.

Capability parity with the reference's json_to_svg
(dataset/utils/json_to_svg.py:53-163): polyline renders with per-edge
colors, non-scaling strokes, start-point markers, per-face group SVGs, and
a JSON->SVG/PNG batch CLI. svgwrite/cairosvg are replaced by direct XML
string assembly; PNG output engages only when cairosvg is importable.
"""

from __future__ import annotations

import argparse
import colorsys
import json
import os
from typing import List, Optional, Sequence


def _color(i: int, n: int) -> str:
    r, g, b = colorsys.hsv_to_rgb((i / max(n, 1)) % 1.0, 0.85, 0.9)
    return f"#{int(r * 255):02x}{int(g * 255):02x}{int(b * 255):02x}"


def _bounds(edges) -> tuple:
    xs = [p[0] for e in edges for p in e]
    ys = [p[1] for e in edges for p in e]
    return min(xs), min(ys), max(xs), max(ys)


def render_svg(
    edges: Sequence,
    width: int = 256,
    height: int = 256,
    padding: float = 0.2,
    line_width: float = 6 / 256,
    mark_starts: bool = True,
    colors: Optional[Sequence[str]] = None,
) -> str:
    """Render polyline edges to an SVG document string. ``colors`` overrides
    the default per-edge hue ramp with an explicit stroke per edge."""
    if not edges:
        return f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" height="{height}"/>'
    x0, y0, x1, y1 = _bounds(edges)
    span = max(x1 - x0, y1 - y0, 1e-9)
    pad = span * padding
    view = (x0 - pad, y0 - pad, span + 2 * pad, span + 2 * pad)
    parts: List[str] = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" height="{height}" '
        f'viewBox="{view[0]:.6g} {view[1]:.6g} {view[2]:.6g} {view[3]:.6g}">'
    ]
    stroke = line_width * span
    for i, edge in enumerate(edges):
        pts = " ".join(f"{p[0]:.6g},{p[1]:.6g}" for p in edge)
        color = colors[i] if colors is not None else _color(i, len(edges))
        # no vector-effect: the reference marks non-scaling-stroke
        # (json_to_svg.py:36) but its user-unit width only renders because
        # cairosvg ignores the effect; spec-compliant renderers (browsers,
        # Inkscape) would draw ~0.05 px hairlines. Our width is
        # span-compensated, so plain scaling strokes render correctly
        # everywhere at the same visual weight as the reference's PNGs.
        parts.append(
            f'<polyline points="{pts}" fill="none" stroke="{color}" '
            f'stroke-width="{stroke:.6g}"/>')
        if mark_starts:
            parts.append(
                f'<circle cx="{edge[0][0]:.6g}" cy="{edge[0][1]:.6g}" '
                f'r="{stroke:.6g}" fill="{color}"/>')
    parts.append("</svg>")
    return "".join(parts)


def render_svg_groups(groups: Sequence, **kwargs) -> str:
    """One SVG containing every group's edges, colored per group
    (reference save_svg_groups: per-face exploded visualization). Colors
    are passed per edge up front — the previous post-hoc string recolor
    corrupted strokes whenever a group hue collided with a later edge's
    placeholder hue."""
    flat, colors = [], []
    for gi, group in enumerate(groups):
        for edge_list in group:
            flat.append(edge_list)
            colors.append(_color(gi, len(groups)))
    return render_svg(flat, mark_starts=False, colors=colors, **kwargs)


def save_svg(edges, path: str, **kwargs) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(render_svg(edges, **kwargs))


def rasterize_edges(edges: Sequence, width: int = 256, height: int = 256,
                    padding: float = 0.2, line_px: int = 3):
    """Dependency-free rasterization of polyline edges to a grayscale
    uint8 image (white background, black ink), using render_svg's exact
    viewBox mapping so native renders and cairosvg renders binarize the
    same way in the 3-view filter (filter_3view.py thresholds at 254)."""
    import numpy as np

    img = np.full((height, width), 255, dtype=np.uint8)
    if not edges:
        return img
    x0, y0, x1, y1 = _bounds(edges)
    span = max(x1 - x0, y1 - y0, 1e-9)
    pad = span * padding
    vx, vy, vs = x0 - pad, y0 - pad, span + 2 * pad
    half = max(line_px // 2, 0)
    offs = [(dy, dx) for dy in range(-half, half + 1)
            for dx in range(-half, half + 1)
            if dx * dx + dy * dy <= half * half + half]
    for edge in edges:
        pts = np.asarray(edge, dtype=float)
        px = (pts[:, 0] - vx) / vs * width
        py = (pts[:, 1] - vy) / vs * height
        for i in range(len(pts) - 1):
            n = int(np.hypot(px[i + 1] - px[i], py[i + 1] - py[i])) * 2 + 2
            ts = np.linspace(0.0, 1.0, n)
            xs = np.clip((px[i] + ts * (px[i + 1] - px[i])).astype(int),
                         0, width - 1)
            ys = np.clip((py[i] + ts * (py[i + 1] - py[i])).astype(int),
                         0, height - 1)
            for dy, dx in offs:
                img[np.clip(ys + dy, 0, height - 1),
                    np.clip(xs + dx, 0, width - 1)] = 0
    return img


def write_png(img, path: str) -> None:
    """Minimal 8-bit grayscale PNG writer (zlib only, no imaging deps)."""
    import struct
    import zlib

    import numpy as np

    img = np.asarray(img, dtype=np.uint8)
    h, w = img.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))
    payload = (b"\x89PNG\r\n\x1a\n"
               + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
               + chunk(b"IDAT", zlib.compress(raw, 6))
               + chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(payload)


def save_png(svg_path: str, png_path: str, width: int = 256,
             height: int = 256, edges: Optional[Sequence] = None) -> bool:
    """Rasterize an SVG; falls back to the dependency-free polyline
    rasterizer when cairosvg is unavailable and the caller supplied the
    edges. Returns False only when neither path is possible."""
    try:
        from cairosvg import svg2png
    except ImportError:
        if edges is None:
            return False
        write_png(rasterize_edges(edges, width, height), png_path)
        return True
    with open(svg_path) as f:
        svg2png(bytestring=f.read().encode(), write_to=png_path,
                output_width=width, output_height=height)
    return True


def _render_one(args) -> None:
    root, n, width, height = args
    with open(os.path.join(root, "json", f"{n}.json")) as f:
        data = json.load(f)
    svg_path = os.path.join(root, "svg", f"{n}.svg")
    save_svg(data["edges"], svg_path, width=width, height=height)
    save_png(svg_path, os.path.join(root, "png", f"{n}.png"), width, height)


def json_to_svg_png(root: str, name: Optional[str] = None,
                    width: int = 256, height: int = 256,
                    num_cores: int = 1, chunksize: int = 10) -> None:
    """Batch JSON -> SVG (+PNG when possible), reference CLI surface
    (json_to_svg.py:104-163) including its process_map fan-out."""
    os.makedirs(os.path.join(root, "svg"), exist_ok=True)
    os.makedirs(os.path.join(root, "png"), exist_ok=True)
    names = ([name] if name else
             [os.path.splitext(n)[0] for n in os.listdir(os.path.join(root, "json"))])
    work = [(root, n, width, height) for n in names]
    if num_cores > 1:
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(max_workers=num_cores) as pool:
            list(pool.map(_render_one, work, chunksize=chunksize))
    else:
        for item in work:
            _render_one(item)


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="render dataset JSONs to SVG/PNG")
    parser.add_argument("--root", type=str, required=True)
    parser.add_argument("--name", type=str, default=None)
    parser.add_argument("--width", type=int, default=256)
    parser.add_argument("--height", type=int, default=256)
    parser.add_argument("--num_cores", type=int, default=1)
    parser.add_argument("--num_chunks", type=int, default=10)
    args = parser.parse_args(argv)
    json_to_svg_png(args.root, args.name, args.width, args.height,
                    args.num_cores, args.num_chunks)


if __name__ == "__main__":
    main()
