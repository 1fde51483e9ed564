"""Face-level metrics (PyTorch port's copy of faceformer_tpu/train/metrics.py;
reference: faceformer/trainer.py:153-300).

  - flat single-sequence grids split at EOS then SEP (direction-token grids
    into [edge pointer, DIR0/DIR1] pairs); anchor-parallel grid rows are
    cut at their first face-type token, which doubles as EOS and encodes
    the type;
  - coedge and direction-token datasets filter by enclosedness, compute a
    coedge-sequence accuracy, then map coedges to canonical edges
    (direction-token faces: to undirected edge sets);
  - faces canonicalize to (majority-vote type, sorted unique edge set);
  - TP = exact set match; precision = TP/|pred|, recall = TP/|label|,
    type_acc = type matches / TP;
  - plus a token-level accuracy over non-PAD label positions.

The enclosedness filter runs in the host library, one C call for a
sample's predicted faces and one for its label faces over edges flattened
once (``geometry/native.py::filter_faces_by_encloseness_batch``, equal to
the Python predicate); direction-token faces, whose indices carry
orientations, go to the Python predicate.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from faceformer_tpu_torch.config import PostProcessConfig, TokenConfig
from faceformer_tpu_torch.geometry.native import (
    filter_faces_by_encloseness_batch,
    flatten_edges,
)
from faceformer_tpu_torch.post_processing import map_coedge_into_edges

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


def _upto_first_eos(seq: np.ndarray, tok: TokenConfig) -> np.ndarray:
    return np.split(seq, np.where(seq == tok.EOS)[0] + 1)[0]


def parse_faces(
    predicts: np.ndarray, labels: np.ndarray, num_edges: int, tok: TokenConfig
) -> Tuple[List[Face], List[Face]]:
    """Parse flat single-sequence grids (reference: trainer.py:153-177).
    Returns (predict_faces, label_faces); types are always 0 for this task
    flavor."""
    label = _upto_first_eos(labels, tok)
    predict = _upto_first_eos(predicts, tok)

    label_faces = []
    for chunk in np.split(label, np.where(label == tok.SEP)[0] + 1):
        vals = chunk[:-1] - tok.length  # strip SEP/EOS, remove offset
        vals = vals[(vals >= 0) & (vals < num_edges)]
        if len(vals) > 0:
            label_faces.append((0, tuple(vals.tolist())))

    predict_faces = []
    for chunk in np.split(predict, np.where(predict == tok.SEP)[0] + 1):
        if len(chunk) > 1:
            vals = chunk[:-1] - tok.length
            vals = vals[(vals >= 0) & (vals < num_edges)]
            if len(vals) > 0:
                predict_faces.append((0, tuple(vals.tolist())))

    return predict_faces, label_faces


def parse_directed_faces(
    predicts: np.ndarray, labels: np.ndarray, num_edges: int, tok: TokenConfig
) -> Tuple[List[Face], List[Face]]:
    """Parse flat grids of the --direction_token flavor: faces are streams of
    [edge_pointer, DIR0/DIR1] pairs between SEPs. Malformed fragments (an
    edge pointer without a following DIR token, or vice versa) are skipped:
    the eval-time tolerance for model hallucinations, as the plain parser
    clips out-of-range pointers."""

    def parse(seq):
        faces = []
        for chunk in np.split(seq, np.where(seq == tok.SEP)[0] + 1):
            arr = chunk[:-1] if len(chunk) else chunk
            items, i = [], 0
            while i < len(arr):
                v = int(arr[i]) - tok.length
                if (0 <= v < num_edges and i + 1 < len(arr)
                        and int(arr[i + 1]) in (tok.DIR0, tok.DIR1)):
                    items.append((v, int(arr[i + 1]) - tok.DIR0))
                    i += 2
                else:
                    i += 1
            if items:
                faces.append((0, tuple(items)))
        return faces

    return parse(_upto_first_eos(predicts, tok)), parse(_upto_first_eos(labels, tok))


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
        """predicts/labels: (F, T) anchor-parallel or (T,) flat token grids."""
        edges = raw_data["edges"]
        if labels.ndim == 2:
            predict_faces, label_faces = parse_parallel_faces(
                predicts, labels, len(edges), self.tok)
        elif self.post_process.direction_token:
            predict_faces, label_faces = parse_directed_faces(
                predicts, labels, len(edges), self.tok)
        else:
            predict_faces, label_faces = parse_faces(
                predicts, labels, len(edges), self.tok)

        out: Dict = {}
        # the oriented flavors share the filter -> coedge-seq-accuracy ->
        # flatten-to-edge-sets pipeline; only the final mapping differs
        to_edge_sets = None
        if self.post_process.direction_token:
            # oriented loops must chain; after the filter, faces compare as
            # undirected edge sets (the flavor stores each edge once)
            def to_edge_sets(faces):
                return [
                    (ftype, [i for loop in loops for (i, _o) in loop])
                    for ftype, loops in faces
                ]
        elif self.post_process.is_coedge:
            # label-free serving passes wireframes without pairings: the
            # mapping then keeps coedge indices as they are
            pairings = raw_data.get("pairings", {})

            def to_edge_sets(faces):
                return [
                    (ftype, map_coedge_into_edges(
                        pairings, [i for loop in loops for i in loop]))
                    for ftype, loops in faces
                ]

        if to_edge_sets is not None:
            tol = self.post_process.enclosedness_tol
            # direction-token faces take the Python predicate: no flattening
            flat = None if self.post_process.direction_token else flatten_edges(edges)
            predict_faces = filter_faces_by_encloseness_batch(edges, predict_faces, tol, flat)
            label_faces = filter_faces_by_encloseness_batch(edges, label_faces, tol, flat)
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

        Reference quirk kept on purpose: for the parallel model the
        elementwise grid comparison pairs decode rows (anchored per edge
        index) with label rows (packed in face/loop/rotation order,
        data_para.py:71-95), so the rows generally hold different rotations
        and even a perfect model scores below 1.0. The reference computes
        the same number on the same grids; it is a training-progress
        diagnostic, never a headline metric (checkpoints are chosen by
        valid_precision). The flat model's rows are aligned (SOS at column
        0 on both sides), where this is a true token accuracy."""
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
