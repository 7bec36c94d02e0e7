"""Evaluators (counterpart of ``paddle_tpu.evaluator``): a Trainer's eval
pass over a reader with its metrics averaged, and ``DetectionMAP``
(metrics.py DetectionMAP / detection_map_op.cc analog), 11-point or
integral, on the host as in the reference."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Sequence

import numpy as np
import torch

from .metrics import MetricBase


class Evaluator:
    """Runs a Trainer's eval over a reader and averages ``metric_keys``
    over its batches."""

    def __init__(self, trainer, feed_names: Sequence[str], dtypes=None,
                 metric_keys: Sequence[str] = ("acc",)):
        from .data.feeder import DataFeeder

        self.trainer = trainer
        self.feeder = DataFeeder(list(feed_names), dtypes)
        self.metric_keys = list(metric_keys)

    def evaluate(self, reader) -> Dict[str, float]:
        sums = defaultdict(float)
        count = 0
        for samples in reader():
            out = self.trainer.eval(self.feeder.feed(samples))
            for k in self.metric_keys:
                sums[k] += float(out[k])
            count += 1
        return {k: v / max(count, 1) for k, v in sums.items()}


def _rows(x):
    return x.detach().cpu().tolist() if isinstance(x, torch.Tensor) else x


class DetectionMAP(MetricBase):
    """Mean average precision for detection, ``ap_version`` "11point" or
    "integral" (metrics.py DetectionMAP / detection_map_op.cc)."""

    def __init__(self, name=None, overlap_threshold: float = 0.5,
                 ap_version: str = "integral"):
        super().__init__(name)
        self.overlap_threshold = overlap_threshold
        self.ap_version = ap_version
        self.reset()

    def reset(self):
        # per class: (score, tp) of each detection, and the gt count
        self.scored = defaultdict(list)
        self.gt_count = defaultdict(int)

    @staticmethod
    def _iou(a, b):
        ix1 = max(a[0], b[0]); iy1 = max(a[1], b[1])  # noqa: E702
        ix2 = min(a[2], b[2]); iy2 = min(a[3], b[3])  # noqa: E702
        inter = max(ix2 - ix1, 0.0) * max(iy2 - iy1, 0.0)
        ua = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter)
        return inter / ua if ua > 0 else 0.0

    def update(self, detections, gts):
        """detections: per image, rows (label, score, x1, y1, x2, y2);
        gts: per image, rows (label, x1, y1, x2, y2). Tensors are read
        once each."""
        for dets, g in zip(detections, gts):
            dets, g = _rows(dets), _rows(g)
            for (lab, *_rest) in g:
                self.gt_count[int(lab)] += 1
            used = set()
            for det in sorted(dets, key=lambda d: -d[1]):
                lab, score = int(det[0]), det[1]
                box = det[2:]
                best, best_j = 0.0, -1
                for j, gt in enumerate(g):
                    if int(gt[0]) != lab or j in used:
                        continue
                    i = self._iou(box, gt[1:])
                    if i > best:
                        best, best_j = i, j
                tp = best >= self.overlap_threshold
                if tp:
                    used.add(best_j)
                self.scored[lab].append((score, 1.0 if tp else 0.0))

    def eval(self) -> float:
        aps = []
        for lab, items in self.scored.items():
            npos = self.gt_count.get(lab, 0)
            if npos == 0:
                continue
            items = sorted(items, key=lambda x: -x[0])
            tps = np.cumsum([t for _, t in items])
            fps = np.cumsum([1 - t for _, t in items])
            recall = tps / npos
            precision = tps / np.maximum(tps + fps, 1e-12)
            if self.ap_version == "11point":
                ap = np.mean([precision[recall >= r].max() if (recall >= r).any() else 0.0
                              for r in np.linspace(0, 1, 11)])
            else:
                ap = 0.0
                prev_r = 0.0
                for p, r in zip(precision, recall):
                    ap += p * (r - prev_r)
                    prev_r = r
            aps.append(ap)
        return float(np.mean(aps)) if aps else 0.0


__all__ = ["DetectionMAP", "Evaluator"]
