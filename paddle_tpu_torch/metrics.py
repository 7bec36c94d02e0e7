"""Metrics (counterpart of ``paddle_tpu.metrics``): the in-graph helpers
(``accuracy``, ``auc_stat``, the streaming ``auc`` layer and
``chunk_eval_counts``) in torch, and the host-side accumulators
(``Accuracy``, ``Precision``, ``Recall``, ``Auc``, ``EditDistance``,
``CompositeMetric``, ``ChunkEvaluator``, ``chunk_eval``) with the JAX
package's numpy state. An accumulator reads a device tensor it is given
once an ``update``; ``DetectionMAP`` lives with the evaluators and is
reached from here by name, as in the JAX package."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch


def _np(x):
    """A host copy of an update's input (one read of a device tensor)."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- in-graph helpers (layers/metric_op.py analog) ---------------------------


def accuracy(input, label, k: int = 1):
    """Per-batch top-k accuracy (accuracy_op.cc analog), through
    ``torch.topk``. Where logits tie at the k-th place, ``torch.topk`` and
    ``jax.lax.top_k`` may keep different indices, so the two agree on
    logits without ties."""
    lab = label.long()
    if lab.dim() == input.dim() and lab.shape[-1] == 1:
        lab = lab[..., 0]
    idx = torch.topk(input, k, dim=-1).indices
    correct = torch.any(idx == lab.unsqueeze(-1), dim=-1)
    return correct.float().mean()


def auc_stat(pred_pos, label, num_thresholds: int = 200):
    """Per-batch AUC histograms (auc_op.cc analog): (tp_hist, fp_hist)
    int32 over ``num_thresholds`` buckets."""
    lab = label.reshape(-1).bool()
    p = torch.clamp(pred_pos.reshape(-1), 0.0, 1.0)
    bucket = torch.clamp((p * num_thresholds).int(), max=num_thresholds - 1).long()
    z = torch.zeros(num_thresholds, dtype=torch.int32, device=p.device)
    return (z.index_add(0, bucket, lab.int()), z.index_add(0, bucket, (~lab).int()))


# -- host-side accumulators (metrics.py analog) ------------------------------


class MetricBase:
    def __init__(self, name: Optional[str] = None):
        self._name = name or self.__class__.__name__

    def reset(self):
        raise NotImplementedError

    def update(self, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class Accuracy(MetricBase):
    """Weighted running accuracy (metrics.py Accuracy)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight=1.0):
        self.value += float(value) * float(weight)
        self.weight += float(weight)

    def eval(self):
        if self.weight == 0:
            raise ValueError("Accuracy: no updates yet")
        return self.value / self.weight


def _binary(preds, labels):
    return (_np(preds).round().astype(np.int64).reshape(-1),
            _np(labels).astype(np.int64).reshape(-1))


class Precision(MetricBase):
    """Binary precision (metrics.py Precision)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds, labels = _binary(preds, labels)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def eval(self):
        d = self.tp + self.fp
        return self.tp / d if d else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds, labels = _binary(preds, labels)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def eval(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.0


class Auc(MetricBase):
    """Threshold-bucketed ROC AUC (metrics.py Auc / auc_op.cc)."""

    def __init__(self, name=None, num_thresholds: int = 200):
        super().__init__(name)
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self.tp_hist = np.zeros(self.num_thresholds, np.int64)
        self.fp_hist = np.zeros(self.num_thresholds, np.int64)

    def update(self, preds, labels):
        """preds: prob of the positive class [N] or [N, 2]; labels: [N]."""
        p = _np(preds)
        if p.ndim == 2 and p.shape[1] == 2:
            p = p[:, 1]
        p = np.clip(p.reshape(-1), 0.0, 1.0)
        lab = _np(labels).reshape(-1).astype(bool)
        bucket = np.minimum((p * self.num_thresholds).astype(np.int64),
                            self.num_thresholds - 1)
        np.add.at(self.tp_hist, bucket, lab.astype(np.int64))
        np.add.at(self.fp_hist, bucket, (~lab).astype(np.int64))

    def update_stats(self, tp, fp):
        """Accumulate the histograms of the in-graph :func:`auc_stat`."""
        self.tp_hist += _np(tp).astype(np.int64)
        self.fp_hist += _np(fp).astype(np.int64)

    def eval(self):
        # cumulative from the highest threshold down: the ROC sweep
        tp_c = np.cumsum(self.tp_hist[::-1]).astype(np.float64)
        fp_c = np.cumsum(self.fp_hist[::-1]).astype(np.float64)
        tot_p, tot_n = tp_c[-1], fp_c[-1]
        if tot_p == 0 or tot_n == 0:
            return 0.0
        tpr = np.concatenate([[0.0], tp_c / tot_p])
        fpr = np.concatenate([[0.0], fp_c / tot_n])
        return float(np.trapezoid(tpr, fpr))


class EditDistance(MetricBase):
    """Mean Levenshtein distance over sequence pairs (metrics.py
    EditDistance); ``eval`` gives (mean distance, share of pairs with
    an error)."""

    def __init__(self, name=None, normalized: bool = True):
        super().__init__(name)
        self.normalized = normalized
        self.reset()

    def reset(self):
        self.total = 0.0
        self.count = 0
        self.seq_num_err = 0

    @staticmethod
    def _levenshtein(a: Sequence, b: Sequence) -> int:
        m, n = len(a), len(b)
        dp = list(range(n + 1))
        for i in range(1, m + 1):
            prev = dp[0]
            dp[0] = i
            for j in range(1, n + 1):
                cur = dp[j]
                dp[j] = min(dp[j] + 1, dp[j - 1] + 1, prev + (a[i - 1] != b[j - 1]))
                prev = cur
        return dp[n]

    def update(self, hyps, refs):
        if isinstance(hyps, torch.Tensor):
            hyps = _np(hyps)
        if isinstance(refs, torch.Tensor):
            refs = _np(refs)
        for h, r in zip(hyps, refs):
            d = self._levenshtein(list(h), list(r))
            if self.normalized:
                d = d / max(len(r), 1)
            self.total += d
            self.count += 1
            if d > 0:
                self.seq_num_err += 1

    def eval(self):
        if self.count == 0:
            raise ValueError("EditDistance: no updates yet")
        return self.total / self.count, self.seq_num_err / self.count


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.metrics: List[MetricBase] = []

    def add_metric(self, m: MetricBase):
        self.metrics.append(m)

    def reset(self):
        for m in self.metrics:
            m.reset()

    def update(self, **kwargs):
        for m in self.metrics:
            m.update(**kwargs)

    def eval(self):
        return [m.eval() for m in self.metrics]


def chunk_eval(hyp_chunks, ref_chunks):
    """Chunk-level (precision, recall, F1) (chunk_eval_op analog) over
    sets of (start, end, type) tuples a sequence."""
    tp = sum(len(set(h) & set(r)) for h, r in zip(hyp_chunks, ref_chunks))
    nh = sum(len(h) for h in hyp_chunks)
    nr = sum(len(r) for r in ref_chunks)
    p = tp / nh if nh else 0.0
    r = tp / nr if nr else 0.0
    f1 = 2 * p * r / (p + r) if p + r else 0.0
    return p, r, f1


def auc(input, label, curve: str = "ROC", num_thresholds: int = 200, name=None):
    """In-graph streaming AUC (layers.auc / auc_op.cc): persistable tp/fp
    histograms accumulated across steps in the program's state, integrated
    by the (0,0)-anchored sweep of ``Auc.eval`` (the precision-recall
    curve: anchored at recall 0, precision 1). ``input`` [B, 2] two-class probabilities. Returns
    (auc_value, batch_auc_value)."""
    from . import initializer as init
    from .core.errors import enforce
    from .framework import LayerHelper

    enforce(curve in ("ROC", "PR"), f"auc: unknown curve {curve!r}")
    helper = LayerHelper("auc", name=name)
    tp_b, fp_b = auc_stat(input[:, 1], torch.as_tensor(label, device=input.device),
                          num_thresholds)

    def _auc(tp_hist, fp_hist):
        tp_c = torch.flip(tp_hist, [0]).cumsum(0).float()
        fp_c = torch.flip(fp_hist, [0]).cumsum(0).float()
        zero = torch.zeros(1, device=tp_c.device)
        if curve == "PR":
            recall = torch.cat([zero, tp_c]) / torch.clamp(tp_c[-1], min=1e-8)
            # precision is 1 by convention while no prediction is positive
            prec = torch.where(tp_c + fp_c > 0, tp_c / torch.clamp(tp_c + fp_c, min=1e-8), 1.0)
            precision = torch.cat([torch.ones(1, device=tp_c.device), prec])
            return torch.sum((recall[1:] - recall[:-1]) * (precision[1:] + precision[:-1]) / 2.0)
        tpr = torch.cat([zero, tp_c]) / torch.clamp(tp_c[-1], min=1e-8)
        fpr = torch.cat([zero, fp_c]) / torch.clamp(fp_c[-1], min=1e-8)
        return torch.sum((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1]) / 2.0)

    stats = {}
    for nm, batch in (("tp", tp_b), ("fp", fp_b)):
        acc = helper.create_variable(nm, (num_thresholds,), torch.int32,
                                     initializer=init.Constant(0.0))
        stats[nm] = acc + batch
        helper.assign_variable(nm, stats[nm])
    return _auc(stats["tp"], stats["fp"]), _auc(tp_b, fp_b)


class ChunkEvaluator(MetricBase):
    """Streaming chunk-level (precision, recall, F1) from the counts of
    :func:`chunk_eval_counts` (metrics.py ChunkEvaluator)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks: int, num_label_chunks: int,
               num_correct_chunks: int):
        self.num_infer_chunks += int(num_infer_chunks)
        self.num_label_chunks += int(num_label_chunks)
        self.num_correct_chunks += int(num_correct_chunks)

    def eval(self):
        precision = (self.num_correct_chunks / self.num_infer_chunks
                     if self.num_infer_chunks else 0.0)
        recall = (self.num_correct_chunks / self.num_label_chunks
                  if self.num_label_chunks else 0.0)
        f1 = (2 * precision * recall / (precision + recall)
              if self.num_correct_chunks else 0.0)
        return precision, recall, f1


def __getattr__(name):
    # the reference's metrics.__all__ has DetectionMAP; it lives with the
    # evaluators
    if name == "DetectionMAP":
        from .evaluator import DetectionMAP
        return DetectionMAP
    raise AttributeError(name)


def chunk_eval_counts(inference, label, lengths, num_chunk_types: int,
                      chunk_scheme: str = "IOB"):
    """In-graph chunk counting (chunk_eval_op.cc analog) over [b, t] tag
    ids encoded ``chunk_type * tag_num + tag`` (IOB: B 0, I 1; IOE: I 0,
    E 1; IOBES: B, I, E, S; plain: one tag). Ids past the chunk types and
    positions past ``lengths`` are outside. A chunk is correct when its
    start, end and type all match. Returns (num_infer_chunks,
    num_label_chunks, num_correct_chunks), 0-d int32 tensors."""
    tag_num = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}[chunk_scheme]
    inference = torch.as_tensor(inference)
    dev = inference.device
    b, t = inference.shape
    pos = torch.arange(t, device=dev)[None, :]
    valid = pos < torch.as_tensor(lengths, device=dev).reshape(-1)[:, None]

    def prev(x, fill):
        return torch.cat([torch.full((b, 1), fill, dtype=x.dtype, device=dev), x[:, :-1]], 1)

    def nxt(x, fill):
        return torch.cat([x[:, 1:], torch.full((b, 1), fill, dtype=x.dtype, device=dev)], 1)

    def spans(tags):
        tags = torch.as_tensor(tags, device=dev).long()
        inside = (tags >= 0) & (tags < num_chunk_types * tag_num) & valid
        ctype = torch.where(inside, torch.div(tags, tag_num, rounding_mode="floor"), -1)
        tag = torch.where(inside, tags % tag_num, -1)
        prev_ctype, prev_tag = prev(ctype, -1), prev(tag, -1)
        if chunk_scheme == "plain":
            begin = inside & (ctype != prev_ctype)
        elif chunk_scheme == "IOB":
            is_b, is_i = tag == 0, tag == 1
            cont = is_i & (prev_ctype == ctype) & ((prev_tag == 0) | (prev_tag == 1))
            begin = inside & (is_b | (is_i & ~cont))
        elif chunk_scheme == "IOE":
            begin = inside & ~((prev_ctype == ctype) & (prev_tag == 0))
        else:  # IOBES
            is_b, is_i, is_e, is_s = tag == 0, tag == 1, tag == 2, tag == 3
            cont = (is_i | is_e) & (prev_ctype == ctype) & ((prev_tag == 0) | (prev_tag == 1))
            begin = inside & (is_b | is_s | ((is_i | is_e) & ~cont))
        # continues[i]: token i+1 belongs to the chunk that holds i
        continues = (inside & nxt(inside, False) & ~nxt(begin, True)
                     & (nxt(ctype, -1) == ctype))
        # the run of continues from each position: where its span ends
        runs = [torch.zeros(b, dtype=torch.long, device=dev)]
        for i in range(t - 1, -1, -1):
            runs.append(torch.where(continues[:, i], runs[-1] + 1, 0))
        end = pos + torch.stack(runs[:0:-1], dim=1)
        return begin, ctype, end

    h_begin, h_type, h_end = spans(inference)
    r_begin, r_type, r_end = spans(label)
    correct = h_begin & r_begin & (h_type == r_type) & (h_end == r_end)
    return (h_begin.sum().int(), r_begin.sum().int(), correct.sum().int())


__all__ = [
    "Accuracy", "Auc", "ChunkEvaluator", "CompositeMetric", "EditDistance", "MetricBase",
    "Precision", "Recall", "accuracy", "auc", "auc_stat", "chunk_eval", "chunk_eval_counts",
]
