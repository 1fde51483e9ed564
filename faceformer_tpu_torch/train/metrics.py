"""Face-level metrics for anchor-parallel grids (the parallel-model subset of
faceformer_tpu/train/metrics.py; reference: faceformer/trainer.py:181-300).

  - each grid row is cut at its first face-type token, which doubles as EOS
    and encodes the type;
  - coedge datasets filter by enclosedness, compute a coedge-sequence
    accuracy, then map coedges to canonical edges;
  - faces canonicalize to (majority-vote type, sorted unique edge set);
  - TP = exact set match; precision = TP/|pred|, recall = TP/|label|,
    type_acc = type matches / TP;
  - plus a token-level accuracy over non-PAD label positions.

The enclosedness filter runs the Python predicate; the JAX package may run a
C++ twin of it, which its own tests hold byte-identical.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from faceformer_tpu_torch.config import PostProcessConfig, TokenConfig
from faceformer_tpu_torch.post_processing import (
    filter_faces_by_encloseness,
    map_coedge_into_edges,
)

Face = Tuple[int, tuple]


def _coedge_seq_accuracy(predict_faces, label_faces) -> Tuple[float, float]:
    """Exact loop-decomposition matches + type agreement among them
    (reference: trainer.py:232-252)."""
    face_tp = type_tp = 0
    label_set = set(label_faces)
    for pred_type, pred_face in predict_faces:
        for label_type, label_face in label_set:
            if pred_face == label_face:
                face_tp += 1
                if pred_type == label_type:
                    type_tp += 1
                break
    accuracy = face_tp / len(predict_faces) if predict_faces else 0
    type_acc = type_tp / face_tp if predict_faces and face_tp else 0
    return accuracy, type_acc


def parse_parallel_faces(
    predicts: np.ndarray, labels: np.ndarray, num_edges: int, tok: TokenConfig
) -> Tuple[List[Face], List[Face]]:
    """Parse per-anchor grids (reference: trainer.py:181-208). Each row is
    cut at its first face-type token.

    Reference quirk kept on purpose: a row that never emits a type token is
    NOT dropped — its face gets the garbage type ``chunk[-1] - offset``,
    exactly as the reference's ``predict[-1] - face_type_offset`` does."""

    def is_type_token(seq):
        return (seq >= tok.face_type_offset) & (seq < tok.length)

    def parse_rows(rows, clip_to_edges):
        faces = []
        for row in rows:
            chunk = np.split(row, np.where(is_type_token(row))[0] + 1)[0]
            face_type = int(chunk[-1]) - tok.face_type_offset
            vals = chunk - tok.length
            vals = vals[vals >= 0]
            if clip_to_edges:
                vals = vals[vals < num_edges]
            if len(vals) > 0:
                faces.append((face_type, tuple(vals.tolist())))
        return faces

    return parse_rows(predicts, True), parse_rows(labels, False)


class FaceMetrics:
    """Per-sample face metrics (reference: trainer.py:210-300 face_accuracy)."""

    def __init__(self, post_process: PostProcessConfig, tok: TokenConfig):
        self.post_process = post_process
        self.tok = tok

    def evaluate_sample(
        self, predicts: np.ndarray, labels: np.ndarray, raw_data: Dict
    ) -> Dict:
        """predicts/labels: (F, T) anchor-parallel token grids."""
        if labels.ndim != 2:
            raise ValueError("the port evaluates anchor-parallel (F, T) grids only")
        edges = raw_data["edges"]
        predict_faces, label_faces = parse_parallel_faces(
            predicts, labels, len(edges), self.tok)

        out: Dict = {}
        if self.post_process.is_coedge:
            # label-free serving passes wireframes without pairings: the
            # mapping then keeps coedge indices as they are
            pairings = raw_data.get("pairings", {})

            def to_edge_sets(faces):
                return [
                    (ftype, map_coedge_into_edges(
                        pairings, [i for loop in loops for i in loop]))
                    for ftype, loops in faces
                ]

            tol = self.post_process.enclosedness_tol
            predict_faces = filter_faces_by_encloseness(edges, predict_faces, tol)
            label_faces = filter_faces_by_encloseness(edges, label_faces, tol)
            out["accuracy"], out["type_acc_coedge_seq"] = _coedge_seq_accuracy(
                predict_faces, label_faces)
            predict_faces = to_edge_sets(predict_faces)
            label_faces = to_edge_sets(label_faces)

        # canonicalize: dedup labels, majority-vote predicted types
        # (reference: trainer.py:257-269)
        label_set = list({(ft, tuple(sorted(set(ix)))) for ft, ix in label_faces})
        by_face: Dict[tuple, List[int]] = {}
        for ftype, indices in predict_faces:
            by_face.setdefault(tuple(sorted(set(indices))), []).append(ftype)
        predict_set = [
            (Counter(types).most_common(1)[0][0], face) for face, types in by_face.items()
        ]

        face_tp = type_tp = 0
        for pred_type, pred_face in predict_set:
            for label_type, label_face in label_set:
                if pred_face == label_face:
                    face_tp += 1
                    if pred_type == label_type:
                        type_tp += 1
                    break

        if not predict_set or not label_set:
            out.update(precision=0, recall=0, type_acc=0)
        else:
            out["precision"] = face_tp / len(predict_set)
            out["recall"] = face_tp / len(label_set)
            out["type_acc"] = type_tp / face_tp if face_tp else 0
        out["predictions"] = predict_set
        out["labels"] = label_set
        return out

    def evaluate_batch(
        self,
        predicts: np.ndarray,
        labels: np.ndarray,
        raw_datas: Sequence[Dict],
        sample_valid: Optional[Sequence[bool]] = None,
    ) -> Dict[str, List]:
        """Evaluate every valid sample of a batch; returns dict-of-lists plus
        the batch token accuracy over labels > PAD (reference:
        trainer.py:296-300).

        Reference quirk kept on purpose: the elementwise grid comparison
        pairs decode rows (anchored per edge index) with label rows (packed
        in face/loop/rotation order, data_para.py:71-95), so the rows
        generally hold different rotations and even a perfect model scores
        below 1.0. The reference computes the same number on the same
        grids; it is a training-progress diagnostic, never a headline
        metric (checkpoints are chosen by valid_precision)."""
        results: Dict[str, List] = {
            k: []
            for k in ("precision", "recall", "type_acc", "accuracy",
                      "type_acc_coedge_seq", "predictions", "labels")
        }
        for i in range(len(labels)):
            if sample_valid is not None and not sample_valid[i]:
                continue
            out = self.evaluate_sample(predicts[i], labels[i], raw_datas[i])
            for key in results:
                if key in out:
                    results[key].append(out[key])

        valid = labels > self.tok.PAD
        if sample_valid is not None:
            valid = valid & np.asarray(sample_valid).reshape(
                -1, *([1] * (labels.ndim - 1)))
        acc_sum = (valid & (predicts == labels)).sum()
        results["token_accuracy"] = float(acc_sum / max(valid.sum(), 1))
        return results
