"""Static-shape packing of wireframe samples into model-ready arrays (a
copy of faceformer_tpu/data/packing.py's inputs and both label layouts).

Edge index i becomes token i + token.length, because the encoder memory
prepends the special-token rows, so pointer logits are indexable by token
id.
  - single-sequence labels (the flat model): [SOS, face1..., SEP, face2...,
    SEP, ..., EOS, PAD...], the SEP after the last face overwritten by EOS;
  - parallel labels: one row per rotation of each face loop, terminated by
    a face-type token (1=Plane, 2=Cylinder, 3=Other; the type doubles as
    EOS); the remaining rows get a bare Other token.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from faceformer_tpu_torch.config import ModelConfig, TokenConfig
from faceformer_tpu_torch.geometry.sampling import resample_edge_batch


def pack_input_edges(edges: Sequence, cfg: ModelConfig,
                     impl: str = "native") -> Dict[str, np.ndarray]:
    """Edges -> (L, P, D) float input + (L,) bool padding mask (True = pad).

    Mask semantics match the reference (data.py:68-70): True marks padded
    rows, which downstream becomes the attention key-padding mask.
    ``impl`` picks the resampler (``resample_edge_batch``).
    """
    inputs = resample_edge_batch(edges, cfg.num_lines, cfg.num_points_per_line, cfg.point_dim,
                                 impl=impl)
    input_mask = np.ones(cfg.num_lines, dtype=bool)
    input_mask[: len(edges)] = False
    return {"input": inputs, "input_mask": input_mask, "num_input": len(edges)}


def _flatten(list_of_lists):
    return [item for sub in list_of_lists for item in sub]


def _is_direction_face(face) -> bool:
    """True for --direction_token faces: loops of (index, orientation) pairs."""
    if not len(face) or isinstance(face[0], (int, np.integer)):
        return False
    first = face[0]
    return bool(len(first)) and not isinstance(first[0], (int, np.integer))


def pack_label_single(faces_indices: Sequence, cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """Flat-sequence label packing (reference: data.py:71-92).

    ``faces_indices`` entries are flat index lists (combined-coedge data),
    nested loop lists (flattened), or --direction_token loops of (index,
    orientation) pairs, which interleave the edge pointer with a DIR0/DIR1
    token: [..., idx+len, DIR(orient), ...]. Every token stays a pointer into
    encoder memory (DIR0/DIR1 are special-token rows 4 and 5, token.length
    6)."""
    tok: TokenConfig = cfg.token
    label = np.full(cfg.label_seq_length, tok.PAD, dtype=np.int32)
    label[0] = tok.SOS
    pos = 0
    for face in faces_indices:
        if _is_direction_face(face):
            seq = []
            for loop in face:
                for idx, orient in loop:
                    seq.extend([int(idx) + tok.length, tok.DIR0 + int(orient)])
            face_tokens = np.asarray(seq, dtype=np.int32)
        else:
            if len(face) and not isinstance(face[0], (int, np.integer)):
                face = _flatten(face)
            face_tokens = np.asarray(face, dtype=np.int32) + tok.length
        pos += 1
        if pos + len(face_tokens) + 1 > cfg.label_seq_length:
            # the reference's length filter counts 1 + len(face) a face
            # (filters/filter_length.py:22-24), which under-counts nested and
            # direction-token faces: say so rather than fail inside numpy
            raise ValueError(
                f"label sequence needs > {cfg.label_seq_length} tokens "
                f"(face of {len(face_tokens)} tokens at position {pos}) — "
                "raise token.len_label / label budget or filter the sample")
        label[pos : pos + len(face_tokens)] = face_tokens
        pos += len(face_tokens)
        label[pos] = tok.SEP
    label[pos] = tok.EOS  # overwrite the trailing SEP
    return {
        "label": label,
        "label_mask": label == tok.PAD,
        "num_label": pos + 1,
    }


def face_type_token(face_type: int, tok: TokenConfig) -> int:
    """Clamp the CAD surface type to {Plane, Cylinder, Other} and shift by
    face_type_offset (reference: data_para.py:75-80)."""
    return (face_type if face_type <= 1 else 2) + tok.face_type_offset


def pack_label_parallel(faces_indices: Sequence, cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """Per-edge-anchor label packing (reference: data_para.py:71-98).

    ``faces_indices`` entries are (face type, loops). Every rotation of
    every loop becomes one training row: the rotated loop followed by the
    face's other loops, +length offset, terminated by the face-type token.
    Rows beyond the real rotations get a bare Other token. Row count is
    bounded by num_lines because each coedge belongs to exactly one face
    loop.
    """
    tok: TokenConfig = cfg.token
    L, T = cfg.num_lines, cfg.max_face_length
    label = np.full((L, T), tok.PAD, dtype=np.int32)
    row = 0
    for entry in faces_indices:
        ftype, loops = entry
        type_token = face_type_token(int(ftype), tok)
        for loop in loops:
            others = _flatten([lp for lp in loops if lp != loop])
            for rot in range(len(loop)):
                seq = list(np.roll(loop, rot, axis=0)) + others
                if row >= L:
                    raise ValueError(
                        "more loop rotations than num_lines — not coedge data?")
                if len(seq) + 1 > T:
                    raise ValueError(
                        f"face sequence length {len(seq) + 1} exceeds max_face_length={T}")
                label[row, : len(seq)] = np.asarray(seq, dtype=np.int32) + tok.length
                label[row, len(seq)] = type_token
                row += 1
    # bare Other-type token on unused rows; the decode engines seed inactive
    # anchor rows with the same token
    label[row:, 0] = face_type_token(2, tok)
    return {
        "label": label,
        "label_mask": label == tok.PAD,
        "num_faces": len(faces_indices),
    }


def count_rotation_rows(faces_indices: Sequence) -> int:
    """Total rotation rows a sample produces; equals the coedge count for
    well-formed coedge data (each coedge belongs to exactly one face loop)."""
    return sum(sum(len(loop) for loop in loops) for _, loops in faces_indices)
