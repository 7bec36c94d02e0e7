"""Detection ops (counterpart of ``paddle_tpu.layers.detection``; prior_box,
box_coder, iou_similarity, multiclass_nms, the SSD loss, the RoI and RPN
family and the SSD head).

Every output has a static shape, as in the JAX package: NMS returns
``max_out`` slots a class, a suppressed slot holding index ``-1`` and
score ``-1.0``, with a ``valid`` mask. The greedy loops (``nms``,
``bipartite_match``) run a fixed number of device steps and read nothing
back to the host inside, so a caller may capture them. Ties go where the
JAX functions send them: ``torch.argmax`` returns the first maximum, as
``jnp.argmax`` does, and ``lax.top_k`` (lower index first) and
``jnp.argsort`` are stable sorts. Batched callers pass leading dims that
the JAX functions take through ``vmap``. Boxes are [x1, y1, x2, y2].
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..framework import current_device, next_rng_key

INF = float("inf")


def iou_similarity(x, y, eps: float = 1e-10):
    """Pairwise IoU (iou_similarity_op): x [..., n, 4], y [..., m, 4] ->
    [..., n, m]."""
    x = x[..., :, None, :]
    y = y[..., None, :, :]
    ix1 = torch.maximum(x[..., 0], y[..., 0])
    iy1 = torch.maximum(x[..., 1], y[..., 1])
    ix2 = torch.minimum(x[..., 2], y[..., 2])
    iy2 = torch.minimum(x[..., 3], y[..., 3])
    inter = torch.clamp(ix2 - ix1, min=0.0) * torch.clamp(iy2 - iy1, min=0.0)
    ax = torch.clamp(x[..., 2] - x[..., 0], min=0.0) * torch.clamp(x[..., 3] - x[..., 1], min=0.0)
    ay = torch.clamp(y[..., 2] - y[..., 0], min=0.0) * torch.clamp(y[..., 3] - y[..., 1], min=0.0)
    return inter / torch.clamp(ax + ay - inter, min=eps)


def box_coder(prior_box, prior_box_var, target_box, code_type: str = "encode_center_size",
              box_normalized: bool = True):
    """box_coder_op: encode target boxes against their priors (1:1), or
    decode offsets into boxes. Leading dims broadcast."""
    one = 0.0 if box_normalized else 1.0
    pw = prior_box[..., 2] - prior_box[..., 0] + one
    ph = prior_box[..., 3] - prior_box[..., 1] + one
    pcx = prior_box[..., 0] + pw * 0.5
    pcy = prior_box[..., 1] + ph * 0.5
    var = (prior_box_var if prior_box_var is not None
           else torch.ones((1, 4), dtype=torch.float32, device=target_box.device))
    if code_type == "encode_center_size":
        tw = target_box[..., 2] - target_box[..., 0] + one
        th = target_box[..., 3] - target_box[..., 1] + one
        tcx = target_box[..., 0] + tw * 0.5
        tcy = target_box[..., 1] + th * 0.5
        return torch.stack([
            (tcx - pcx) / pw / var[..., 0],
            (tcy - pcy) / ph / var[..., 1],
            torch.log(torch.clamp(tw / pw, min=1e-10)) / var[..., 2],
            torch.log(torch.clamp(th / ph, min=1e-10)) / var[..., 3],
        ], dim=-1)
    dcx = var[..., 0] * target_box[..., 0] * pw + pcx
    dcy = var[..., 1] * target_box[..., 1] * ph + pcy
    dw = torch.exp(var[..., 2] * target_box[..., 2]) * pw
    dh = torch.exp(var[..., 3] * target_box[..., 3]) * ph
    return torch.stack([dcx - dw * 0.5, dcy - dh * 0.5,
                        dcx + dw * 0.5 - one, dcy + dh * 0.5 - one], dim=-1)


# prior_box's results by (arguments, device): built once, so a captured
# step that builds its head's priors copies nothing from the host
_PRIORS: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def prior_box(input_hw: Tuple[int, int], image_hw: Tuple[int, int],
              min_sizes: Sequence[float], max_sizes: Sequence[float] = (),
              aspect_ratios: Sequence[float] = (1.0,), flip: bool = False,
              clip: bool = False, steps=(0.0, 0.0), offset: float = 0.5,
              variance=(0.1, 0.1, 0.2, 0.2), device=None):
    """prior_box_op (SSD anchors): (boxes [h, w, k, 4], variances
    [h, w, k, 4]) in f32 on ``device`` (default: the running program's).
    As in the JAX function, ratio 1 is not added: list it. The tensors are
    built once for each set of arguments and device, and shared. They are
    built on the host and copied, so the card's priors are the CPU's bits:
    CUDA divides by a host scalar through its reciprocal, and a prior an ulp
    away can break a tie in the IoU of two mirrored priors otherwise."""
    dev = current_device(device)
    key = (tuple(input_hw), tuple(image_hw), tuple(min_sizes), tuple(max_sizes),
           tuple(aspect_ratios), flip, clip, tuple(steps), offset, tuple(variance), dev)
    if key not in _PRIORS:
        _PRIORS[key] = tuple(t.to(dev) for t in _prior_box(
            input_hw, image_hw, min_sizes, max_sizes, aspect_ratios, flip, clip, steps,
            offset, variance))
    return _PRIORS[key]


def _prior_box(input_hw, image_hw, min_sizes, max_sizes, aspect_ratios, flip, clip, steps,
               offset, variance):
    """prior_box's tensors, built on the CPU."""
    h, w = input_hw
    img_h, img_w = image_hw
    step_h = steps[0] or img_h / h
    step_w = steps[1] or img_w / w
    ars = list(aspect_ratios)
    if flip:
        ars += [1.0 / a for a in aspect_ratios if a != 1.0]
    whs = []
    for ms in min_sizes:
        for ar in ars:
            whs.append((ms * math.sqrt(ar), ms / math.sqrt(ar)))
        for big in max_sizes:
            whs.append((math.sqrt(ms * big), math.sqrt(ms * big)))
    whs = torch.tensor(whs, dtype=torch.float32)                         # [k, 2]
    cy = (torch.arange(h)[:, None] + offset) * step_h
    cx = (torch.arange(w)[None, :] + offset) * step_w
    cx = cx.float().expand(h, w)[..., None]
    cy = cy.float().expand(h, w)[..., None]
    bw = whs[:, 0][None, None, :] * 0.5
    bh = whs[:, 1][None, None, :] * 0.5
    boxes = torch.stack([(cx - bw) / img_w, (cy - bh) / img_h,
                         (cx + bw) / img_w, (cy + bh) / img_h], dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = torch.tensor(variance, dtype=torch.float32).expand(boxes.shape)
    return boxes, var


def _nms(boxes, scores, max_out: int, iou_threshold: float, score_threshold: float):
    """Greedy NMS over leading dims: boxes [..., n, 4] (broadcast against
    scores), scores [..., n] -> (boxes [..., max_out, 4], scores
    [..., max_out], valid, indices [..., max_out], -1 where empty).
    ``max_out`` device steps; the IoU row of each chosen box is computed in
    its step, not as an n x n table."""
    n = scores.shape[-1]
    boxes = boxes.expand(*scores.shape, 4)
    live = scores > score_threshold
    neg = torch.full((), -INF, dtype=scores.dtype, device=scores.device)
    idxs, outs = [], []
    for _ in range(max_out):
        masked = torch.where(live, scores, neg)
        best = torch.argmax(masked, dim=-1, keepdim=True)                # [..., 1]
        top = torch.gather(masked, -1, best)
        ok = top > -INF
        idxs.append(torch.where(ok, best, -1))
        outs.append(torch.where(ok, top, -1.0))
        chosen = torch.gather(boxes, -2, best[..., None].expand(*best.shape, 4))
        suppress = iou_similarity(chosen, boxes)[..., 0, :] >= iou_threshold
        live = (live & ~suppress & ok).scatter(-1, best, False)
    out_idx = torch.cat(idxs, dim=-1)
    out_scores = torch.cat(outs, dim=-1).to(torch.float32)
    valid = out_idx >= 0
    safe = torch.clamp(out_idx, 0, n - 1)
    picked = torch.gather(boxes, -2, safe[..., None].expand(*safe.shape, 4))
    return torch.where(valid[..., None], picked, 0.0), out_scores, valid, out_idx


def nms(boxes, scores, max_out: int, iou_threshold: float = 0.5,
        score_threshold: float = 0.0):
    """Single-class NMS, static shape: (boxes [max_out, 4], scores
    [max_out], valid); a suppressed slot has score -1."""
    return _nms(boxes, scores, max_out, iou_threshold, score_threshold)[:3]


def multiclass_nms(bboxes, scores, max_per_class: int, iou_threshold: float = 0.45,
                   score_threshold: float = 0.01):
    """multiclass_nms_op, static: bboxes [n, 4], scores [c, n] -> (boxes
    [c, max, 4], scores [c, max], labels [c, max], valid [c, max])."""
    return _multiclass_nms(bboxes, scores, max_per_class, iou_threshold, score_threshold)[:4]


def _multiclass_nms(bboxes, scores, max_per_class, iou_threshold, score_threshold):
    out_boxes, out_scores, valid, idx = _nms(bboxes[..., None, :, :], scores, max_per_class,
                                             iou_threshold, score_threshold)
    c = scores.shape[-2]
    labels = torch.arange(c, dtype=torch.int32, device=scores.device)[:, None] \
        .expand(out_scores.shape)
    return out_boxes, out_scores, labels, valid, idx


def density_prior_box(input_hw, image_hw, fixed_sizes, fixed_ratios, densities,
                      steps=(0.0, 0.0), offset: float = 0.5, device=None):
    """density_prior_box_op analog: [h, w, k, 4] f32 boxes, built on the
    host as the JAX function builds them, then moved to ``device``."""
    h, w = input_hw
    img_h, img_w = image_hw
    step_h = steps[0] or img_h / h
    step_w = steps[1] or img_w / w
    boxes = []
    for size, density in zip(fixed_sizes, densities):
        shift = size / density
        for ar in fixed_ratios:
            bw = size * math.sqrt(ar)
            bh = size / math.sqrt(ar)
            for di in range(density):
                for dj in range(density):
                    boxes.append((bw, bh, -size / 2 + shift / 2 + dj * shift,
                                  -size / 2 + shift / 2 + di * shift))
    k = len(boxes)
    arr = np.asarray(boxes, np.float32)
    cy = np.broadcast_to((np.arange(h)[:, None, None] + offset) * step_h, (h, w, k))
    cx = np.broadcast_to((np.arange(w)[None, :, None] + offset) * step_w, (h, w, k))
    out = np.stack([(cx + arr[:, 2] - arr[:, 0] / 2) / img_w,
                    (cy + arr[:, 3] - arr[:, 1] / 2) / img_h,
                    (cx + arr[:, 2] + arr[:, 0] / 2) / img_w,
                    (cy + arr[:, 3] + arr[:, 1] / 2) / img_h], axis=-1)
    return torch.from_numpy(out.astype(np.float32)).to(current_device(device))


def bipartite_match(dist):
    """bipartite_match_op (greedy max): dist [..., n, m] similarity ->
    (match_indices [..., m] int32, -1 where unmatched; match_dist [..., m]).
    min(n, m) device steps, each taking the first maximum of the table."""
    *lead, n, m = dist.shape
    d = dist.reshape(-1, n, m)
    b = d.shape[0]
    rows = torch.arange(n, device=d.device)[None, :, None]
    cols = torch.arange(m, device=d.device)[None, None, :]
    idx = torch.full((b, m), -1, dtype=torch.int32, device=d.device)
    val = torch.zeros((b, m), dtype=dist.dtype, device=d.device)
    for _ in range(min(n, m)):
        flat = torch.argmax(d.reshape(b, -1), dim=1)                     # [b]
        r, c = flat // m, flat % m
        top = d.reshape(b, -1).gather(1, flat[:, None])                  # [b, 1]
        ok = top > 0
        at_c = cols[0] == c[:, None]                                     # [b, m]
        idx = torch.where(at_c & ok, r[:, None].int(), idx)
        val = torch.where(at_c & ok, top, val)
        cross = (rows == r[:, None, None]) | (cols == c[:, None, None])
        d = torch.where(cross & ok[:, :, None], -1.0, d)
    return idx.reshape(*lead, m), val.reshape(*lead, m)


def ssd_loss(location, confidence, gt_box_offsets, gt_labels, match_mask,
             neg_pos_ratio: float = 3.0, loc_weight: float = 1.0,
             conf_weight: float = 1.0):
    """ssd_loss_op core (pre-matched): smooth-L1 on matched locations plus
    softmax CE with hard negative mining (the ``neg_pos_ratio`` x matched
    count hardest negatives, ranked by a stable double argsort).
    location [n, p, 4], confidence [n, p, c], gt_box_offsets [n, p, 4],
    gt_labels [n, p] (0 = background), match_mask [n, p] (1 = matched)."""
    diff = location - gt_box_offsets
    absd = torch.abs(diff)
    loc_l = torch.where(absd < 1.0, 0.5 * diff * diff, absd - 0.5).sum(-1)
    denom = torch.clamp(match_mask.sum(), min=1.0)
    loc_loss = (loc_l * match_mask).sum() / denom
    logp = torch.log_softmax(confidence, dim=-1)
    ce = -torch.gather(logp, -1, gt_labels.long()[..., None])[..., 0]
    pos = match_mask > 0
    num_pos = pos.sum(dim=1)
    neg_ce = torch.where(pos, -INF, ce.detach())
    order = torch.argsort(-neg_ce, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    num_neg = torch.minimum((num_pos * neg_pos_ratio).int(), (~pos).sum(dim=1).int())
    neg_sel = rank < num_neg[:, None]
    conf_loss = torch.where(pos | neg_sel, ce, 0.0).sum() / denom
    return loc_weight * loc_loss + conf_weight * conf_loss


def yolo_box(x, img_size, anchors: Sequence[int], class_num: int,
             conf_thresh: float = 0.01, downsample_ratio: int = 32):
    """yolo_box_op: decode a YOLOv3 head x [n, k*(5+c), h, w] -> (boxes
    [n, h*w*k, 4], scores [n, h*w*k, c])."""
    n, _, h, w = x.shape
    k = len(anchors) // 2
    an = torch.tensor(anchors, dtype=torch.float32, device=x.device).reshape(k, 2)
    x = x.reshape(n, k, 5 + class_num, h, w)
    gx = (torch.sigmoid(x[:, :, 0]) + torch.arange(w, device=x.device)[None, None, None, :]) / w
    gy = (torch.sigmoid(x[:, :, 1]) + torch.arange(h, device=x.device)[None, None, :, None]) / h
    gw = torch.exp(x[:, :, 2]) * an[None, :, 0, None, None] / (w * downsample_ratio)
    gh = torch.exp(x[:, :, 3]) * an[None, :, 1, None, None] / (h * downsample_ratio)
    conf = torch.sigmoid(x[:, :, 4])
    prob = torch.sigmoid(x[:, :, 5:]) * conf[:, :, None]
    prob = torch.where(conf[:, :, None] > conf_thresh, prob, 0.0)
    img_h, img_w = img_size
    boxes = torch.stack([(gx - gw / 2) * img_w, (gy - gh / 2) * img_h,
                         (gx + gw / 2) * img_w, (gy + gh / 2) * img_h], dim=2)
    boxes = boxes.permute(0, 1, 3, 4, 2).reshape(n, -1, 4)
    scores = prob.permute(0, 1, 3, 4, 2).reshape(n, -1, class_num)
    return boxes, scores


def _host(v):
    return v.detach().cpu().tolist() if isinstance(v, torch.Tensor) else v


def detection_map(detect_res, gt_label, gt_box, class_num: int,
                  overlap_threshold: float = 0.5, ap_version: str = "integral"):
    """detection_map_op analog, on the host as the reference's CPU-only
    kernel: one batch's mAP through ``evaluator.DetectionMAP``.
    detect_res: per image, rows (label, score, x1, y1, x2, y2);
    gt_label/gt_box: per image."""
    from ..evaluator import DetectionMAP

    m = DetectionMAP(overlap_threshold=overlap_threshold, ap_version=ap_version)
    gts = [[(int(lab),) + tuple(box) for lab, box in zip(_host(labs), _host(boxes))]
           for labs, boxes in zip(gt_label, gt_box)]
    m.update([_host(d) for d in detect_res], gts)
    return m.eval()


# -- the RoI / RPN family (static shapes: padded outputs and valid masks) ------


def roi_pool(input, rois, rois_batch_idx, pooled_height: int = 1,
             pooled_width: int = 1, spatial_scale: float = 1.0):
    """RoI max pooling (roi_pool_op.cc): input [N, C, H, W], rois [R, 4]
    in image coordinates, rois_batch_idx [R]. The reference's
    round/floor/ceil bins; an empty bin gives 0. The max of a rectangular
    bin is taken over H, then over W."""
    n, c, h, w = input.shape
    dev = input.device
    roi = torch.round(rois.float() * spatial_scale)
    x1, y1, x2, y2 = roi[:, 0], roi[:, 1], roi[:, 2], roi[:, 3]
    # divided by device tensors: CUDA divides by a host scalar through its
    # reciprocal, whose rounding would move a bin edge off an integer
    bin_h = torch.clamp(y2 - y1 + 1.0, min=1.0) / torch.full((), pooled_height, device=dev)
    bin_w = torch.clamp(x2 - x1 + 1.0, min=1.0) / torch.full((), pooled_width, device=dev)
    ph = torch.arange(pooled_height, dtype=torch.float32, device=dev)
    pw = torch.arange(pooled_width, dtype=torch.float32, device=dev)
    hstart = torch.clamp(torch.floor(ph[None, :] * bin_h[:, None]) + y1[:, None], 0, h)
    hend = torch.clamp(torch.ceil((ph[None, :] + 1) * bin_h[:, None]) + y1[:, None], 0, h)
    wstart = torch.clamp(torch.floor(pw[None, :] * bin_w[:, None]) + x1[:, None], 0, w)
    wend = torch.clamp(torch.ceil((pw[None, :] + 1) * bin_w[:, None]) + x1[:, None], 0, w)
    feats = input[rois_batch_idx.long()]                                # [R, C, H, W]
    hh = torch.arange(h, dtype=torch.float32, device=dev)
    hmask = (hh[None, None, :] >= hstart[:, :, None]) & (hh[None, None, :] < hend[:, :, None])
    rowmax = torch.where(hmask[:, None, :, :, None], feats[:, :, None, :, :],
                         -INF).amax(dim=3)                              # [R, C, Ph, W]
    ww = torch.arange(w, dtype=torch.float32, device=dev)
    wmask = (ww[None, None, :] >= wstart[:, :, None]) & (ww[None, None, :] < wend[:, :, None])
    out = torch.where(wmask[:, None, None, :, :], rowmax[:, :, :, None, :],
                      -INF).amax(dim=4)                                 # [R, C, Ph, Pw]
    return torch.where(torch.isfinite(out), out, 0.0).to(input.dtype)


def _bilinear(input, bidx, ys, xs):
    """Bilinear samples of input [N, C, H, W] for each roi r at the points
    (ys[r, ...], xs[r, ...]) (broadcast together): [R, C, *points], each
    corner clamped into the map, as the JAX samplers do."""
    _, _, h, w = input.shape
    y0 = torch.clamp(torch.floor(ys), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs), 0, w - 1)
    y1i = torch.clamp(y0 + 1, 0, h - 1).long()
    x1i = torch.clamp(x0 + 1, 0, w - 1).long()
    y0i, x0i = y0.long(), x0.long()
    ly = torch.clamp(ys - y0, 0.0, 1.0)
    lx = torch.clamp(xs - x0, 0.0, 1.0)
    b = bidx.long().reshape(-1, *([1] * (ys.dim() - 1)))

    def at(yy, xx):                                                     # [R, *points, C]
        return input[b, :, yy, xx]

    v = (at(y0i, x0i) * ((1 - ly) * (1 - lx))[..., None]
         + at(y0i, x1i) * ((1 - ly) * lx)[..., None]
         + at(y1i, x0i) * (ly * (1 - lx))[..., None]
         + at(y1i, x1i) * (ly * lx)[..., None])
    return v.movedim(-1, 1)


def roi_align(input, rois, rois_batch_idx, pooled_height: int = 1,
              pooled_width: int = 1, spatial_scale: float = 1.0,
              sampling_ratio: int = 2):
    """RoI align (roi_align_op.cc): the mean of ``sampling_ratio``²
    bilinear samples a bin (a static ratio, as in the JAX function)."""
    _, c, _, _ = input.shape
    dev = input.device
    s = max(sampling_ratio, 1)
    roi = rois.float() * spatial_scale
    x1, y1, x2, y2 = roi[:, 0], roi[:, 1], roi[:, 2], roi[:, 3]
    bin_h = torch.clamp(y2 - y1, min=1.0) / pooled_height
    bin_w = torch.clamp(x2 - x1, min=1.0) / pooled_width
    iy = torch.arange(pooled_height * s, dtype=torch.float32, device=dev)
    ix = torch.arange(pooled_width * s, dtype=torch.float32, device=dev)
    ys = y1[:, None] + torch.div(iy[None, :], s, rounding_mode="floor") * bin_h[:, None] \
        + ((iy[None, :] % s) + 0.5) * bin_h[:, None] / s
    xs = x1[:, None] + torch.div(ix[None, :], s, rounding_mode="floor") * bin_w[:, None] \
        + ((ix[None, :] % s) + 0.5) * bin_w[:, None] / s
    vals = _bilinear(input, rois_batch_idx, ys[:, :, None], xs[:, None, :])
    vals = vals.reshape(vals.shape[0], c, pooled_height, s, pooled_width, s)
    return vals.mean(dim=(3, 5)).to(input.dtype)


def anchor_generator(input, anchor_sizes: Sequence[float], aspect_ratios: Sequence[float],
                     variance=(0.1, 0.1, 0.2, 0.2), stride=(16.0, 16.0),
                     offset: float = 0.5):
    """RPN anchors (anchor_generator_op.cc): input [N, C, H, W] ->
    (anchors [H, W, A, 4] in image coordinates, variances [H, W, A, 4])."""
    dev = input.device
    h, w = input.shape[2], input.shape[3]
    sw, sh = float(stride[0]), float(stride[1])
    f32 = dict(dtype=torch.float32, device=dev)
    ws, hs = [], []
    for ar in aspect_ratios:
        for size in anchor_sizes:
            base_w = torch.round(torch.sqrt(torch.tensor(sw * sh / ar, **f32)))
            base_h = torch.round(base_w * ar)
            ws.append(size / sw * base_w)
            hs.append(size / sh * base_h)
    ws, hs = torch.stack(ws), torch.stack(hs)
    cx = torch.arange(w, **f32) * sw + offset * sw
    cy = torch.arange(h, **f32) * sh + offset * sh
    gx, gy = torch.meshgrid(cx, cy, indexing="xy")                     # [H, W]
    anchors = torch.stack([gx[:, :, None] - 0.5 * (ws - 1.0), gy[:, :, None] - 0.5 * (hs - 1.0),
                           gx[:, :, None] + 0.5 * (ws - 1.0), gy[:, :, None] + 0.5 * (hs - 1.0)],
                          dim=-1)
    return anchors, torch.tensor(variance, **f32).expand(anchors.shape)


def _top_k(x, k):
    """``lax.top_k`` along the last dim: a stable descending sort, so the
    lower index comes first among ties (``torch.topk`` on the card does
    not promise it)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _clip_to(x, hi):
    return torch.minimum(torch.clamp(x, min=0.0), hi)


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n: int = 6000, post_nms_top_n: int = 1000,
                       nms_thresh: float = 0.5, min_size: float = 0.1,
                       eta: float = 1.0):
    """RPN proposals (generate_proposals_op.cc): per image, top-k ->
    decode -> clip -> min-size filter -> NMS. scores [N, A, H, W],
    bbox_deltas [N, 4A, H, W], anchors/variances [H, W, A, 4], im_info
    [N, 3] (h, w, scale). Returns (rois [N, post, 4], roi_probs [N, post],
    valid [N, post])."""
    n, a, h, w = scores.shape
    total = a * h * w
    anc = anchors.permute(2, 0, 1, 3).reshape(total, 4)
    var = variances.permute(2, 0, 1, 3).reshape(total, 4)
    k = min(pre_nms_top_n, total)
    sc = scores.reshape(n, total)
    bd = bbox_deltas.reshape(n, a, 4, h, w).permute(0, 1, 3, 4, 2).reshape(n, total, 4)
    top_sc, idx = _top_k(sc, k)
    boxes = box_coder(anc[idx], var[idx], torch.gather(bd, 1, idx[..., None].expand(n, k, 4)),
                      code_type="decode_center_size", box_normalized=False)
    img_h, img_w = im_info[:, 0, None], im_info[:, 1, None]
    boxes = torch.stack([_clip_to(boxes[..., 0], img_w - 1), _clip_to(boxes[..., 1], img_h - 1),
                         _clip_to(boxes[..., 2], img_w - 1), _clip_to(boxes[..., 3], img_h - 1)],
                        dim=-1)
    ms = min_size * im_info[:, 2, None]
    keep = ((boxes[..., 2] - boxes[..., 0] + 1) >= ms) & ((boxes[..., 3] - boxes[..., 1] + 1) >= ms)
    top_sc = torch.where(keep, top_sc, -INF)
    return _nms(boxes, top_sc, post_nms_top_n, nms_thresh, -INF)[:3]


def _rank(x):
    """Each element's place in a stable ascending sort along dim 1."""
    return torch.argsort(torch.argsort(x, dim=1, stable=True), dim=1, stable=True)


def _uniform(shape, generator, device):
    g = generator if generator is not None else next_rng_key()
    return torch.rand(shape, generator=g, device=g.device).to(device)


def rpn_target_assign(anchors, gt_boxes, gt_valid, im_info,
                      rpn_batch_size_per_im: int = 256,
                      rpn_straddle_thresh: float = 0.0,
                      rpn_fg_fraction: float = 0.5,
                      rpn_positive_overlap: float = 0.7,
                      rpn_negative_overlap: float = 0.3,
                      generator=None):
    """RPN training targets (rpn_target_assign_op.cc), static shapes:
    per anchor (labels [N, A] in {1 fg, 0 bg, -1 ignore}, bbox_targets
    [N, A, 4], fg_mask, bg_mask), subsampled to the batch size and fg
    fraction by uniform ranks drawn from ``generator`` (default: the
    running program's stream) in place of the JAX package's
    ``jax.random``. anchors [A, 4]; gt_boxes [N, G, 4] with gt_valid
    [N, G]; im_info [N, 3]."""
    n = gt_boxes.shape[0]
    a = anchors.shape[0]
    t = rpn_straddle_thresh
    inside = ((anchors[None, :, 0] >= -t) & (anchors[None, :, 1] >= -t)
              & (anchors[None, :, 2] < im_info[:, 1, None] + t)
              & (anchors[None, :, 3] < im_info[:, 0, None] + t))           # [N, A]
    gtv = gt_valid.bool()
    iou = torch.where(gtv[:, None, :], iou_similarity(anchors, gt_boxes), 0.0)  # [N, A, G]
    best_iou, best_gt = iou.max(dim=2).values, torch.argmax(iou, dim=2)
    gt_best = torch.where(inside[:, :, None], iou, -1.0).amax(dim=1)      # [N, G]
    is_gt_best = ((iou >= gt_best[:, None, :] - 1e-6) & (gt_best[:, None, :] > 0)
                  & gtv[:, None, :]).any(dim=2)
    fg = inside & ((best_iou >= rpn_positive_overlap) | is_gt_best)
    bg = inside & ~fg & (best_iou < rpn_negative_overlap)
    fg_cap = int(rpn_batch_size_per_im * rpn_fg_fraction)
    r = _uniform((n, a), generator, anchors.device)
    fg_keep = fg & (_rank(torch.where(fg, r, 2.0)) < fg_cap)
    bg_cap = rpn_batch_size_per_im - fg_keep.sum(dim=1, keepdim=True)
    bg_keep = bg & (_rank(torch.where(bg, r, 2.0)) < bg_cap)
    labels = torch.where(fg_keep, 1, torch.where(bg_keep, 0, -1)).int()
    matched = torch.gather(gt_boxes, 1, best_gt[..., None].expand(n, a, 4))
    tgt = box_coder(anchors, None, matched, code_type="encode_center_size",
                    box_normalized=False)
    return labels, tgt, fg_keep, bg_keep


def generate_proposal_labels(rois, rois_valid, gt_classes, gt_boxes, gt_valid,
                             batch_size_per_im: int = 512,
                             fg_fraction: float = 0.25,
                             fg_thresh: float = 0.5,
                             bg_thresh_hi: float = 0.5,
                             bg_thresh_lo: float = 0.0,
                             class_nums: int = 81,
                             generator=None):
    """Fast R-CNN head sampling (generate_proposal_labels_op.cc), static
    shapes: per roi (labels [N, R]: the class, 0 background, -1
    unsampled; bbox targets [N, R, 4] against the matched gt, 0 off the
    foreground; fg mask; sampled mask). rois [N, R, 4] with rois_valid
    [N, R]; the gt padded with gt_valid. Ranks are drawn from
    ``generator`` as in :func:`rpn_target_assign`."""
    n, r = rois.shape[:2]
    rv, gv = rois_valid.bool(), gt_valid.bool()
    iou = torch.where(gv[:, None, :] & rv[:, :, None], iou_similarity(rois, gt_boxes), 0.0)
    best_iou, best_gt = iou.max(dim=2).values, torch.argmax(iou, dim=2)
    fg = rv & (best_iou >= fg_thresh)
    bg = rv & (best_iou < bg_thresh_hi) & (best_iou >= bg_thresh_lo)
    fg_cap = int(batch_size_per_im * fg_fraction)
    rnd = _uniform((n, r), generator, rois.device)
    fg_keep = fg & (_rank(torch.where(fg, rnd, 2.0)) < fg_cap)
    bg_cap = batch_size_per_im - fg_keep.sum(dim=1, keepdim=True)
    bg_keep = bg & (_rank(torch.where(bg, rnd, 2.0)) < bg_cap)
    labels = torch.where(fg_keep, torch.gather(gt_classes, 1, best_gt).to(torch.int32),
                         torch.where(bg_keep, 0, -1).int()).int()
    matched = torch.gather(gt_boxes, 1, best_gt[..., None].expand(n, r, 4))
    tgt = box_coder(rois, None, matched, code_type="encode_center_size",
                    box_normalized=False)
    return labels, torch.where(fg_keep[..., None], tgt, 0.0), fg_keep, fg_keep | bg_keep


def target_assign(x, match_indices, mismatch_value: float = 0.0):
    """target_assign_op: out[b, p] = x[b, match_indices[b, p]] where
    matched (index >= 0), else ``mismatch_value`` (an int ``x`` with a
    float ``mismatch_value`` comes out f32, as in JAX); weight 1 on
    matched rows. Returns (out, out_weight [b, p, 1])."""
    b, p = match_indices.shape
    idx = torch.clamp(match_indices, min=0).long()
    gathered = torch.gather(x, 1, idx[:, :, None].expand(b, p, x.shape[-1]))
    matched = (match_indices >= 0)[:, :, None]
    return torch.where(matched, gathered, mismatch_value), matched.float()


def polygon_box_transform(input):
    """EAST geometry restore (polygon_box_transform_op.cc): even channels
    4·w_index − in, odd channels 4·h_index − in; input [N, G, H, W]."""
    _, g, h, w = input.shape
    wi = torch.arange(w, dtype=input.dtype, device=input.device)[None, None, None, :]
    hi = torch.arange(h, dtype=input.dtype, device=input.device)[None, None, :, None]
    even = (torch.arange(g, device=input.device) % 2 == 0)[None, :, None, None]
    return torch.where(even, 4.0 * wi - input, 4.0 * hi - input)


def roi_perspective_transform(input, rois, rois_batch_idx, transformed_height: int,
                              transformed_width: int, spatial_scale: float = 1.0):
    """Warp RoI quads to rectangles (roi_perspective_transform_op.cc):
    rois [R, 8] quad corners (clockwise x1..y4). One 8x8 system a roi
    (output -> input homography) solved by ``torch.linalg.solve`` in f32,
    then bilinear samples, 0 outside the map. Returns [R, C, th, tw]."""
    _, c, h, w = input.shape
    dev = input.device
    quad = rois.float().reshape(-1, 4, 2) * spatial_scale
    r = quad.shape[0]
    tw_, th_ = float(transformed_width - 1), float(transformed_height - 1)
    dst = torch.tensor([[0.0, 0.0], [tw_, 0.0], [tw_, th_], [0.0, th_]], device=dev)
    X, Y = dst[:, 0].expand(r, 4), dst[:, 1].expand(r, 4)
    x, y = quad[..., 0], quad[..., 1]
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    ru = torch.stack([X, Y, one, zero, zero, zero, -X * x, -Y * x], dim=-1)      # [R, 4, 8]
    rv = torch.stack([zero, zero, zero, X, Y, one, -X * y, -Y * y], dim=-1)
    A = torch.stack([ru, rv], dim=2).reshape(r, 8, 8)
    m = torch.linalg.solve(A, torch.stack([x, y], dim=2).reshape(r, 8))
    mats = torch.cat([m, torch.ones((r, 1), device=dev)], dim=1).reshape(r, 3, 3)
    gy, gx = torch.meshgrid(torch.arange(transformed_height, dtype=torch.float32, device=dev),
                            torch.arange(transformed_width, dtype=torch.float32, device=dev),
                            indexing="ij")
    grid = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).reshape(-1, 3)
    src = torch.matmul(grid, mats.transpose(1, 2))                               # [R, P, 3]
    sx = src[..., 0] / torch.clamp(src[..., 2], min=1e-8)
    sy = src[..., 1] / torch.clamp(src[..., 2], min=1e-8)
    v = _bilinear(input, rois_batch_idx, sy, sx)                                 # [R, C, P]
    inb = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    return torch.where(inb[:, None, :], v, 0.0).reshape(
        r, c, transformed_height, transformed_width).to(input.dtype)


def detection_output(loc, scores, prior_boxes, prior_variances,
                     background_label: int = 0, nms_threshold: float = 0.45,
                     nms_top_k: int = 400, keep_top_k: int = 200,
                     score_threshold: float = 0.01):
    """SSD output layer (box_coder decode + multiclass_nms + the top
    ``keep_top_k`` by score): loc [N, P, 4] offsets, scores [N, P, C]
    probabilities, priors [P, 4] and [P, 4]. Returns (rows [N, keep, 6]
    of (label, score, x1, y1, x2, y2), valid [N, keep])."""
    return _detection_output(loc, scores, prior_boxes, prior_variances, background_label,
                             nms_threshold, nms_top_k, keep_top_k, score_threshold)[:2]


def _detection_output(loc, scores, prior_boxes, prior_variances, background_label,
                      nms_threshold, nms_top_k, keep_top_k, score_threshold):
    """:func:`detection_output`'s rows and valid, and the prior of each row
    ([N, keep] int64, -1 where not valid)."""
    boxes = box_coder(prior_boxes, prior_variances, loc, code_type="decode_center_size")
    cls_scores = scores.transpose(1, 2).clone()                                  # [N, C, P]
    cls_scores[:, background_label] = -INF
    bx, bs, labels, valid, prior = _multiclass_nms(boxes, cls_scores, nms_top_k, nms_threshold,
                                                   score_threshold)
    n = loc.shape[0]
    top_sc, idx = _top_k(torch.where(valid, bs, -INF).reshape(n, -1), keep_top_k)
    rows = torch.cat([
        torch.gather(labels.expand(n, *labels.shape[-2:]).reshape(n, -1), 1, idx)[..., None].float(),
        top_sc[..., None],
        torch.gather(bx.reshape(n, -1, 4), 1, idx[..., None].expand(*idx.shape, 4)),
    ], dim=-1)
    kept = torch.isfinite(top_sc)
    return rows, kept, torch.where(kept, torch.gather(prior.reshape(n, -1), 1, idx), -1)


def multi_box_head(inputs, image, base_size: int, num_classes: int,
                   aspect_ratios: Sequence[Sequence[float]],
                   min_ratio: int = 20, max_ratio: int = 90,
                   min_sizes=None, max_sizes=None,
                   steps=None, offset: float = 0.5, flip: bool = True,
                   clip: bool = False, kernel_size: int = 1, pad: int = 0,
                   variance=(0.1, 0.1, 0.2, 0.2), name=None):
    """SSD multi-scale head: per feature map (NCHW), convs predict loc
    (A·4) and conf (A·C), named ``{name}_loc{i}`` and ``{name}_conf{i}``
    (``mbox`` by default) as in the JAX package, beside its prior boxes.
    Returns (mbox_locs [N, total, 4], mbox_confs [N, total, C], boxes
    [total, 4], variances [total, 4])."""
    from .nn import conv2d

    nmaps = len(inputs)
    img_h, img_w = image.shape[2], image.shape[3]
    if min_sizes is None:
        # the reference's schedule: evenly spaced between min and max ratio
        min_sizes, max_sizes = [], []
        step = int((max_ratio - min_ratio) / (nmaps - 2)) if nmaps > 2 else 0
        for ratio in range(min_ratio, max_ratio + 1, max(step, 1)):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = [base_size * 0.10] + min_sizes[:nmaps - 1]
        max_sizes = [base_size * 0.20] + max_sizes[:nmaps - 1]
    locs, confs, all_boxes, all_vars = [], [], [], []
    for i, feat in enumerate(inputs):
        mins = min_sizes[i]
        maxs = max_sizes[i] if max_sizes else None
        boxes, vars_ = prior_box(
            (feat.shape[2], feat.shape[3]), (img_h, img_w),
            min_sizes=[mins] if not isinstance(mins, (list, tuple)) else mins,
            max_sizes=[maxs] if maxs and not isinstance(maxs, (list, tuple)) else (maxs or ()),
            aspect_ratios=aspect_ratios[i], flip=flip, clip=clip,
            steps=(steps[i] if steps else (0.0, 0.0)), offset=offset, variance=variance,
            device=feat.device)
        a = boxes.shape[2]
        loc = conv2d(feat, a * 4, kernel_size, padding=pad, name=f"{name or 'mbox'}_loc{i}")
        conf = conv2d(feat, a * num_classes, kernel_size, padding=pad,
                      name=f"{name or 'mbox'}_conf{i}")
        nb = feat.shape[0]
        locs.append(loc.permute(0, 2, 3, 1).reshape(nb, -1, 4))
        confs.append(conf.permute(0, 2, 3, 1).reshape(nb, -1, num_classes))
        all_boxes.append(boxes.reshape(-1, 4))
        all_vars.append(vars_.reshape(-1, 4))
    return (torch.cat(locs, dim=1), torch.cat(confs, dim=1),
            torch.cat(all_boxes, dim=0), torch.cat(all_vars, dim=0))


__all__ = [
    "anchor_generator", "bipartite_match", "box_coder", "density_prior_box",
    "detection_map", "detection_output", "generate_proposal_labels",
    "generate_proposals", "iou_similarity", "multi_box_head", "multiclass_nms", "nms",
    "polygon_box_transform", "prior_box", "roi_align", "roi_perspective_transform",
    "roi_pool", "rpn_target_assign", "ssd_loss", "target_assign", "yolo_box",
]
