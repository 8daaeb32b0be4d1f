"""Frame-level set-based detection evaluation, nuScenes-protocol mAP and
NDS (``eval/detection.py`` of the JAX package; numpy).

- greedy centre-distance matching per class: predictions in descending
  confidence; a prediction is a true positive if an unmatched ground truth of
  its class lies within the threshold ({0.5, 1, 2, 4} m);
- AP = mean precision over 101 recall samples, recall and precision below
  10% clipped out and the rest renormalised; mAP = mean over classes and
  thresholds;
- TP errors over the matches at 2 m, by the protocol's recall-sampled
  cumulative means: ATE (2D centre distance), ASE (1 - aligned 3D IoU), AOE
  (yaw difference, period 2 pi; pi for barriers); a class that never reaches
  the minimum recall scores 1.0;
- NDS-3 = (4 mAP + sum over the three TP errors of (1 - min(1, err))) / 7:
  the nuScenes NDS over the errors this model predicts (no velocity or
  attribute heads), reported as ``nds3``.

Inputs are plain numpy structures grouped by frame, so the evaluator takes
``eval/inference.py`` ``recover_boxes`` outputs or any other detector's.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

DIST_THRESHOLDS_M = (0.5, 1.0, 2.0, 4.0)
TP_THRESHOLD_M = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
N_RECALL_SAMPLES = 101
# yaw periods (nuScenes: barriers are symmetric under pi rotation)
_YAW_PERIOD = {"barrier": np.pi}


def _center_dist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise 2D center distance (x, z ground-plane coords in the camera
    frame; nuScenes uses BEV xy — for camera-frame boxes that is (x, z))."""
    d = a[:, None, :] - b[None, :, :]
    return np.sqrt(np.sum(d * d, axis=-1))


def _yaw_err(a: np.ndarray, b: np.ndarray, period: float) -> np.ndarray:
    d = np.abs(a - b) % period
    return np.minimum(d, period - d)


def _aligned_size_iou(sa: np.ndarray, sb: np.ndarray) -> np.ndarray:
    """3D IoU of translation/yaw-aligned boxes: prod(min)/prod(max) of sizes."""
    inter = np.prod(np.minimum(sa, sb), axis=-1)
    union = np.prod(sa, axis=-1) + np.prod(sb, axis=-1) - inter
    return inter / np.maximum(union, 1e-9)


def _match_class(
    preds: List[Dict],
    gts: List[Dict],
    dist_th: float,
) -> Tuple[np.ndarray, np.ndarray, int, List[Tuple[Dict, Dict]]]:
    """Greedy confidence-ordered matching within one class across all frames.

    Returns (tp_flags, confidences, n_gt, matched_pairs). ``preds``/``gts``
    are dicts with 'frame', 'center' (2,), 'size' (3,), 'yaw', 'score'.
    """
    preds = sorted(preds, key=lambda p: -p["score"])
    by_frame: Dict = {}
    for i, g in enumerate(gts):
        by_frame.setdefault(g["frame"], []).append(i)
    taken = set()
    tp = np.zeros(len(preds), dtype=bool)
    pairs: List[Tuple[Dict, Dict]] = []
    for pi, p in enumerate(preds):
        cand = [i for i in by_frame.get(p["frame"], ()) if i not in taken]
        if not cand:
            continue
        centers = np.stack([gts[i]["center"] for i in cand])
        d = np.sqrt(np.sum((centers - p["center"][None, :]) ** 2, axis=-1))
        j = int(np.argmin(d))
        if d[j] <= dist_th:
            taken.add(cand[j])
            tp[pi] = True
            pairs.append((p, gts[cand[j]]))
    conf = np.asarray([p["score"] for p in preds], np.float32)
    return tp, conf, len(gts), pairs


def _protocol_tp_error(errs: np.ndarray, n_gt: int) -> float:
    """nuScenes ``calc_tp`` semantics: per-match errors in confidence order
    -> cumulative mean -> interpolate onto the 101 recall samples ->
    average samples in [min_recall+1 sample, max achieved recall sample].
    Returns the maximal error 1.0 when recall never reaches min_recall."""
    if n_gt == 0 or len(errs) == 0:
        return 1.0
    errs = np.asarray(errs, np.float64)
    cummean = np.cumsum(errs) / (np.arange(errs.size) + 1)
    recall_at_tp = (np.arange(errs.size) + 1) / n_gt
    first_ind = int(round(MIN_RECALL * (N_RECALL_SAMPLES - 1))) + 1
    last_ind = int(np.floor(recall_at_tp[-1] * (N_RECALL_SAMPLES - 1) + 1e-9))
    if last_ind < first_ind:
        return 1.0
    r_samples = np.linspace(0.0, 1.0, N_RECALL_SAMPLES)
    curve = np.interp(r_samples, recall_at_tp, cummean)
    return float(np.mean(curve[first_ind : last_ind + 1]))


def _average_precision(tp: np.ndarray, n_gt: int) -> float:
    """nuScenes-style AP: 101 recall samples, sub-10% recall/precision
    clipped, renormalized. ``tp`` is already confidence-ordered."""
    if n_gt == 0 or tp.size == 0:
        return 0.0
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(~tp)
    recall = cum_tp / n_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1)
    # precision linearly interpolated at 101 recall samples (recall beyond
    # the achieved maximum contributes 0 — the nuScenes-protocol sampling,
    # not the VOC monotone envelope)
    r_samples = np.linspace(0.0, 1.0, N_RECALL_SAMPLES)
    p_at_r = np.interp(r_samples, recall, precision, right=0.0).astype(np.float32)
    # clip sub-minimum operating region and renormalize
    start = int(round(MIN_RECALL * (N_RECALL_SAMPLES - 1))) + 1
    clipped = p_at_r[start:] - MIN_PRECISION
    clipped[clipped < 0] = 0.0
    return float(np.mean(clipped) / (1.0 - MIN_PRECISION))


def evaluate_detections(
    predictions: Sequence[Dict],
    ground_truths: Sequence[Dict],
    class_names: Sequence[str],
    dist_thresholds: Sequence[float] = DIST_THRESHOLDS_M,
) -> Dict[str, float]:
    """Set-based detection metrics.

    Each prediction dict: {'frame': hashable, 'class_name': str,
    'center': (2,) ground-plane center (x, z), 'size': (3,) l/w/h in meters,
    'yaw': float, 'score': float}. Ground truths: same minus 'score'.

    Returns {'mAP', 'nds3', 'mATE', 'mASE', 'mAOE', 'AP/<class>', ...}.
    Classes with no ground truth anywhere are excluded from the means
    (nuScenes convention).
    """
    results: Dict[str, float] = {}
    aps: List[float] = []
    ates: List[float] = []
    ases: List[float] = []
    aoes: List[float] = []
    for cname in class_names:
        preds_c = [p for p in predictions if p["class_name"] == cname]
        gts_c = [g for g in ground_truths if g["class_name"] == cname]
        if not gts_c:
            continue
        ap_per_th = []
        for th in dist_thresholds:
            tp, _conf, n_gt, _pairs = _match_class(preds_c, gts_c, th)
            ap_per_th.append(_average_precision(tp, n_gt))
        ap = float(np.mean(ap_per_th))
        results[f"AP/{cname}"] = ap
        aps.append(ap)

        # TP errors at the fixed 2 m threshold, protocol aggregation:
        # pairs come back in confidence order (greedy matching iterates by
        # descending score), so the cumulative-mean/recall sampling of
        # _protocol_tp_error applies directly
        _tp, _conf, n_gt_c, pairs = _match_class(preds_c, gts_c, TP_THRESHOLD_M)
        if pairs:
            pc = np.stack([p["center"] for p, _ in pairs])
            gc = np.stack([g["center"] for _, g in pairs])
            ate_per = np.sqrt(np.sum((pc - gc) ** 2, axis=-1))
            ps = np.stack([p["size"] for p, _ in pairs])
            gs = np.stack([g["size"] for _, g in pairs])
            ase_per = 1.0 - _aligned_size_iou(ps, gs)
            period = _YAW_PERIOD.get(cname, 2.0 * np.pi)
            py = np.asarray([p["yaw"] for p, _ in pairs])
            gy = np.asarray([g["yaw"] for _, g in pairs])
            aoe_per = _yaw_err(py, gy, period)
            ate = _protocol_tp_error(ate_per, n_gt_c)
            ase = _protocol_tp_error(ase_per, n_gt_c)
            aoe = _protocol_tp_error(aoe_per, n_gt_c)
        else:  # no matches: maximal errors (nuScenes assigns 1.0)
            ate, ase, aoe = 1.0, 1.0, 1.0
        results[f"ATE/{cname}"] = ate
        results[f"ASE/{cname}"] = ase
        results[f"AOE/{cname}"] = aoe
        ates.append(ate)
        ases.append(ase)
        aoes.append(aoe)

    if not aps:
        return {"mAP": 0.0, "nds3": 0.0, "mATE": 1.0, "mASE": 1.0, "mAOE": 1.0}
    m_ap = float(np.mean(aps))
    m_ate = float(np.mean(ates))
    m_ase = float(np.mean(ases))
    m_aoe = float(np.mean(aoes))
    tp_scores = sum(1.0 - min(1.0, e) for e in (m_ate, m_ase, m_aoe))
    results.update(
        {
            "mAP": m_ap,
            "mATE": m_ate,
            "mASE": m_ase,
            "mAOE": m_aoe,
            "nds3": float((4.0 * m_ap + tp_scores) / 7.0),
        }
    )
    return results
