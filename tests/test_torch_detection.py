"""The port's detection ops against ``paddle_tpu.layers.detection`` on the
CPU, on the same numpy inputs made from a seed: every function of the
module, an SSD head's loss and grads through ``params_from_jax``, and the
sampled RPN and Fast R-CNN targets by their invariants.

Tolerances (stated per check): box arithmetic, priors and anchors within
1e-5 (rtol and atol: f32 in another order); NMS, matching and top-k
selections (indices, labels, valid masks) exactly; the warped RoIs within
1e-4 (one 8x8 ``linalg.solve`` a roi, f32); the SSD loss within rtol 1e-5
and each grad within 1e-4 of its largest entry; mAP within 1e-12 (both
host numpy). ``rpn_target_assign`` and ``generate_proposal_labels`` draw
their sampling ranks from ``jax.random`` in the JAX package and from a
``torch.Generator`` in the port: where the quotas cover every candidate,
labels and targets are equal; where they sample, the counts, the quotas
and the targets of the sampled rows are held."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as jpt
from paddle_tpu.layers import detection as jD
from paddle_tpu import layers as jL

import paddle_tpu_torch as tpt
from paddle_tpu_torch.framework import params_from_jax
from paddle_tpu_torch.layers import detection as tD
from paddle_tpu_torch import layers as tL

CPU = tpt.CPUPlace()
TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _jit(fn, **static):
    """A JAX function compiled once with its static arguments bound (its
    ops compiled one by one would take seconds)."""
    return jax.jit(functools.partial(fn, **static))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _equal(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want))


def _boxes(rng, n, size=1.0, lo=0.02):
    xy = rng.rand(n, 2) * size * 0.7
    wh = (lo + rng.rand(n, 2) * 0.3) * size
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


# -- boxes, priors, matching ----------------------------------------------------


def test_iou_box_coder_prior_and_density_boxes_equal_jax():
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 7), _boxes(rng, 5)
    _close(tD.iou_similarity(_t(a), _t(b)), jD.iou_similarity(a, b))
    var = (0.1 + rng.rand(7, 4)).astype(np.float32)
    for normalized in (True, False):
        scale = 1.0 if normalized else 100.0
        pa, pb = a * scale, _boxes(rng, 7, scale)
        for v in (var, None):
            enc = jD.box_coder(pa, v, pb, "encode_center_size", normalized)
            _close(tD.box_coder(_t(pa), None if v is None else _t(v), _t(pb),
                                "encode_center_size", normalized), enc)
            _close(tD.box_coder(_t(pa), None if v is None else _t(v), _t(np.asarray(enc)),
                                "decode_center_size", normalized),
                   jD.box_coder(pa, v, enc, "decode_center_size", normalized), 1e-4)
    for kw in (dict(min_sizes=[4.0], aspect_ratios=[1.0]),
               dict(min_sizes=[4.0, 8.0], max_sizes=[9.0, 12.0], aspect_ratios=[1.0, 2.0, 3.0],
                    flip=True, clip=True, steps=(4.0, 4.0), offset=0.25)):
        jb, jv = jD.prior_box((5, 6), (20, 24), **kw)
        tb, tv = tD.prior_box((5, 6), (20, 24), device=CPU, **kw)
        _close(tb, jb)
        _close(tv, jv)
    kw = dict(fixed_sizes=[8.0, 16.0], fixed_ratios=[1.0, 2.0], densities=[2, 1])
    _close(tD.density_prior_box((3, 4), (32, 32), device=CPU, **kw),
           jD.density_prior_box((3, 4), (32, 32), **kw))


def _scored_boxes(rng, n):
    base = _boxes(rng, n // 2)
    jitter = (base + rng.randn(*base.shape).astype(np.float32) * 0.01)
    boxes = np.concatenate([base, jitter], 0)            # near-duplicates to suppress
    scores = rng.rand(n).astype(np.float32)
    scores[3] = scores[5]                                # a tie: the lower index first
    return boxes, scores


def test_nms_and_multiclass_nms_equal_jax():
    rng = np.random.RandomState(1)
    boxes, scores = _scored_boxes(rng, 16)
    for max_out, thr in ((20, 0.3), (4, 0.5)):
        want = _jit(jD.nms, max_out=max_out, iou_threshold=thr, score_threshold=0.2)(
            boxes, scores)
        got = tD.nms(_t(boxes), _t(scores), max_out, thr, 0.2)
        _close(got[0], want[0])
        _equal(got[1], want[1])
        _equal(got[2], want[2])
    cls_scores = rng.rand(3, 16).astype(np.float32)
    want = _jit(jD.multiclass_nms, max_per_class=6, iou_threshold=0.45,
                score_threshold=0.3)(boxes, cls_scores)
    got = tD.multiclass_nms(_t(boxes), _t(cls_scores), 6, 0.45, 0.3)
    for g, w in zip(got, want):
        _equal(g, w)


def test_bipartite_match_and_target_assign_equal_jax():
    rng = np.random.RandomState(2)
    dist = rng.rand(3, 4, 9).astype(np.float32)
    dist[0, 1, 2] = dist[0, 2, 5] = 2.0                  # a tie: the first in row-major order
    dist[2] = 0.0                                        # nothing matches
    got_idx, got_val = tD.bipartite_match(_t(dist))
    for i in range(3):
        w_idx, w_val = jD.bipartite_match(dist[i])
        _equal(got_idx[i], w_idx)
        _equal(got_val[i], w_val)
    x = rng.randn(3, 4, 5).astype(np.float32)
    idx = np.asarray(got_idx)
    for mismatch in (0.0, -2.5):
        got = tD.target_assign(_t(x), _t(idx), mismatch)
        want = jD.target_assign(x, idx, mismatch)
        _equal(got[0], want[0])
        _equal(got[1], want[1])
    labels = rng.randint(0, 5, (3, 4, 1)).astype(np.int32)
    got, want = tD.target_assign(_t(labels), _t(idx)), jD.target_assign(labels, idx)
    assert str(got[0].dtype).split(".")[-1] == str(want[0].dtype)
    _equal(got[0], want[0])


# -- losses and heads -----------------------------------------------------------


def test_ssd_loss_and_grads_equal_jax():
    rng = np.random.RandomState(3)
    n, p, c = 3, 20, 4
    loc = rng.randn(n, p, 4).astype(np.float32)
    conf = rng.randn(n, p, c).astype(np.float32)
    tgt = rng.randn(n, p, 4).astype(np.float32)
    labels = rng.randint(1, c, (n, p)).astype(np.int32)
    mask = (rng.rand(n, p) < 0.2).astype(np.float32)
    mask[2] = 0.0                                        # an image with no match
    labels = np.where(mask > 0, labels, 0).astype(np.int32)
    conf[0, :4] = conf[0, 4:8]                           # tied CE among negatives

    def jloss(lc, cf):
        return jD.ssd_loss(lc, cf, tgt, labels, mask)

    want, (wgl, wgc) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(loc),
                                                                 jnp.asarray(conf))
    tl, tc = _t(loc).requires_grad_(True), _t(conf).requires_grad_(True)
    got = tD.ssd_loss(tl, tc, _t(tgt), _t(labels), _t(mask))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for g, w in ((tl.grad, wgl), (tc.grad, wgc)):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-4 * np.abs(np.asarray(w)).max()


def test_yolo_box_and_polygon_box_transform_equal_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 2 * (5 + 3), 4, 5).astype(np.float32)
    want = jD.yolo_box(x, (64, 80), [10, 13, 16, 30], 3, conf_thresh=0.4, downsample_ratio=16)
    got = tD.yolo_box(_t(x), (64, 80), [10, 13, 16, 30], 3, conf_thresh=0.4,
                      downsample_ratio=16)
    _close(got[0], want[0])
    _close(got[1], want[1])
    geo = rng.randn(2, 8, 3, 4).astype(np.float32)
    _close(tD.polygon_box_transform(_t(geo)), jD.polygon_box_transform(geo))


@pytest.mark.parametrize("ap_version", ["integral", "11point"])
def test_detection_map_equal_jax(ap_version):
    rng = np.random.RandomState(5)
    dets, gt_label, gt_box = [], [], []
    for _ in range(4):
        g = _boxes(rng, 3)
        labs = rng.randint(1, 4, 3)
        d = np.concatenate([g + rng.randn(3, 4).astype(np.float32) * 0.02, _boxes(rng, 2)])
        dl = np.concatenate([labs, rng.randint(1, 4, 2)])
        dets.append(np.concatenate([dl[:, None], rng.rand(5, 1), d], 1).astype(np.float32))
        gt_label.append(labs)
        gt_box.append(g)
    want = jD.detection_map([d.tolist() for d in dets], gt_label, gt_box, 4,
                            ap_version=ap_version)
    got = tD.detection_map([_t(d) for d in dets], [_t(x) for x in gt_label],
                           [_t(x) for x in gt_box], 4, ap_version=ap_version)
    assert 0.0 < want < 1.0
    assert abs(got - want) <= 1e-12


# -- the RoI / RPN family -------------------------------------------------------


def _rois(rng, r, h, w):
    x1 = rng.rand(r) * (w - 4)
    y1 = rng.rand(r) * (h - 4)
    return np.stack([x1, y1, x1 + 1 + rng.rand(r) * (w / 2),
                     y1 + 1 + rng.rand(r) * (h / 2)], 1).astype(np.float32)


def test_roi_pool_roi_align_and_perspective_equal_jax():
    rng = np.random.RandomState(6)
    feat = rng.randn(2, 3, 10, 12).astype(np.float32)
    rois = _rois(rng, 5, 20, 24)
    bidx = np.array([0, 1, 1, 0, 1], np.int32)
    _close(tD.roi_pool(_t(feat), _t(rois), _t(bidx), 3, 2, 0.5),
           _jit(jD.roi_pool, pooled_height=3, pooled_width=2, spatial_scale=0.5)(
               feat, rois, bidx))
    _close(tD.roi_align(_t(feat), _t(rois), _t(bidx), 3, 2, 0.5, 2),
           _jit(jD.roi_align, pooled_height=3, pooled_width=2, spatial_scale=0.5,
                sampling_ratio=2)(feat, rois, bidx))
    quads = np.stack([rois[:, 0], rois[:, 1], rois[:, 2], rois[:, 1] + 0.5,
                      rois[:, 2] - 0.3, rois[:, 3], rois[:, 0] + 0.2, rois[:, 3] - 0.4],
                     1).astype(np.float32)
    _close(tD.roi_perspective_transform(_t(feat), _t(quads), _t(bidx), 4, 5, 0.5),
           _jit(jD.roi_perspective_transform, transformed_height=4, transformed_width=5,
                spatial_scale=0.5)(feat, quads, bidx), 1e-4)


def test_anchor_generator_and_generate_proposals_equal_jax():
    rng = np.random.RandomState(7)
    feat = np.zeros((2, 4, 3, 4), np.float32)
    kw = dict(anchor_sizes=[16.0, 32.0], aspect_ratios=[0.5, 1.0, 2.0], stride=(8.0, 8.0))
    ja, jv = jD.anchor_generator(feat, **kw)
    ta, tv = tD.anchor_generator(_t(feat), **kw)
    _close(ta, ja)
    _close(tv, jv)
    a = ta.shape[2]
    scores = rng.rand(2, a, 3, 4).astype(np.float32)
    scores[0, 0, 0, :2] = scores[0, 1, 0, 0]             # ties inside the top-k
    deltas = (rng.randn(2, 4 * a, 3, 4) * 0.2).astype(np.float32)
    im_info = np.array([[24, 32, 1.0], [20, 30, 2.0]], np.float32)
    want = _jit(jD.generate_proposals, pre_nms_top_n=30, post_nms_top_n=12, nms_thresh=0.6,
                min_size=4.0)(scores, deltas, im_info, ja, jv)
    got = tD.generate_proposals(_t(scores), _t(deltas), _t(im_info), ta, tv,
                                pre_nms_top_n=30, post_nms_top_n=12, nms_thresh=0.6,
                                min_size=4.0)
    _close(got[0], want[0], 1e-4)
    _close(got[1], want[1])
    _equal(got[2], want[2])
    assert 0 < int(got[2].sum()) < got[2].numel()


def _rpn_case(rng):
    anchors = _boxes(rng, 40, 64.0, lo=0.1)
    gt = np.stack([_boxes(rng, 3, 64.0, lo=0.2) for _ in range(2)])
    gt[:, 0] = anchors[[5, 9]] + 0.5                    # anchors that surely match
    gt_valid = np.array([[1, 1, 0], [1, 1, 1]], bool)
    im_info = np.array([[64, 64, 1.0], [60, 56, 1.0]], np.float32)
    return anchors, gt, gt_valid, im_info


@pytest.mark.parametrize("sampled", [False, True])
def test_rpn_target_assign_against_jax(sampled):
    rng = np.random.RandomState(8)
    anchors, gt, gt_valid, im_info = _rpn_case(rng)
    kw = dict(rpn_batch_size_per_im=6 if sampled else 1000, rpn_fg_fraction=0.5,
              rpn_positive_overlap=0.5, rpn_negative_overlap=0.3)
    jl, jt, jfg, jbg = (np.asarray(v) for v in _jit(jD.rpn_target_assign, **kw)(
        anchors, gt, gt_valid, im_info, rng_key=jax.random.PRNGKey(0)))
    gen = torch.Generator().manual_seed(0)
    tl_, tt, tfg, tbg = tD.rpn_target_assign(_t(anchors), _t(gt), _t(gt_valid), _t(im_info),
                                             generator=gen, **kw)
    _close(tt, jt, 1e-4)                                 # targets of every anchor
    if not sampled:                                      # the quotas cover every candidate
        _equal(tl_, jl)
        _equal(tfg, jfg)
        _equal(tbg, jbg)
        return
    # sampled: the same candidates, the same counts under the quotas
    for got_fg, got_bg, want_fg, want_bg in ((tfg.numpy(), tbg.numpy(), jfg, jbg),):
        assert (got_fg.sum(1) == want_fg.sum(1)).all() and (got_fg.sum(1) <= 3).all()
        assert (got_bg.sum(1) == want_bg.sum(1)).all()
        assert ((got_fg.sum(1) + got_bg.sum(1)) <= 6).all()
    all_fg = np.asarray(_jit(jD.rpn_target_assign, **dict(kw, rpn_batch_size_per_im=1000))(
        anchors, gt, gt_valid, im_info, rng_key=jax.random.PRNGKey(0))[2])
    assert not (tfg.numpy() & ~all_fg).any()             # sampled from the fg candidates
    _equal(tl_, np.where(tfg.numpy(), 1, np.where(tbg.numpy(), 0, -1)))


@pytest.mark.parametrize("sampled", [False, True])
def test_generate_proposal_labels_against_jax(sampled):
    rng = np.random.RandomState(9)
    anchors, gt, gt_valid, _ = _rpn_case(rng)
    rois = np.stack([anchors[:24], anchors[16:]]).astype(np.float32)
    rois_valid = np.ones((2, 24), bool)
    rois_valid[1, -3:] = False
    gt_classes = rng.randint(1, 5, (2, 3)).astype(np.int32)
    kw = dict(batch_size_per_im=4 if sampled else 1000, fg_fraction=0.5, fg_thresh=0.4,
              bg_thresh_hi=0.4, bg_thresh_lo=0.0, class_nums=5)
    jl, jt, jfg, js = (np.asarray(v) for v in _jit(jD.generate_proposal_labels, **kw)(
        rois, rois_valid, gt_classes, gt, gt_valid, rng_key=jax.random.PRNGKey(1)))
    gen = torch.Generator().manual_seed(1)
    tl_, tt, tfg, ts = tD.generate_proposal_labels(_t(rois), _t(rois_valid), _t(gt_classes),
                                                   _t(gt), _t(gt_valid), generator=gen, **kw)
    if not sampled:
        _equal(tl_, jl)
        _close(tt, jt, 1e-4)
        _equal(tfg, jfg)
        _equal(ts, js)
        return
    assert (tfg.numpy().sum(1) == jfg.sum(1)).all() and (tfg.numpy().sum(1) <= 2).all()
    assert (ts.numpy().sum(1) == js.sum(1)).all() and (ts.numpy().sum(1) <= 4).all()
    full = [np.asarray(v) for v in _jit(jD.generate_proposal_labels,
                                        **dict(kw, batch_size_per_im=1000))(
        rois, rois_valid, gt_classes, gt, gt_valid, rng_key=jax.random.PRNGKey(1))]
    fg = tfg.numpy()
    assert not (fg & ~full[2]).any() and not (ts.numpy() & ~full[3]).any()
    _equal(tl_.numpy()[fg], full[0][fg])                 # the class of a sampled fg
    _close(tt.numpy()[fg], full[1][fg], 1e-4)
    assert (tt.numpy()[~fg] == 0).all()


# -- the SSD output layer and head ----------------------------------------------


def test_detection_output_equal_jax():
    rng = np.random.RandomState(10)
    p, c = 30, 4
    priors = _boxes(rng, p)
    pvar = np.tile(np.array([0.1, 0.1, 0.2, 0.2], np.float32), (p, 1))
    loc = (rng.randn(2, p, 4) * 0.3).astype(np.float32)
    logits = rng.randn(2, p, c).astype(np.float32)
    scores = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    kw = dict(nms_threshold=0.45, nms_top_k=8, keep_top_k=10, score_threshold=0.2)
    want_rows, want_valid = _jit(jD.detection_output, **kw)(loc, scores, priors, pvar)
    got_rows, got_valid = tD.detection_output(_t(loc), _t(scores), _t(priors), _t(pvar), **kw)
    _equal(got_valid, want_valid)
    v = np.asarray(want_valid)
    _equal(got_rows[..., 0].numpy()[v], np.asarray(want_rows)[..., 0][v])  # labels
    _close(got_rows.numpy()[v], np.asarray(want_rows)[v])                    # scores, boxes


SSD_RATIOS = [[1.0, 2.0], [1.0, 2.0, 3.0]]


def _ssd_head(L, D, image, gt_box, gt_label, match):
    f1 = L.conv2d(image, 6, 3, stride=2, padding=1, act="relu", name="feat1")
    f2 = L.conv2d(f1, 6, 3, stride=2, padding=1, act="relu", name="feat2")
    locs, confs, boxes, var = D.multi_box_head(
        [f1, f2], image, base_size=32, num_classes=3, aspect_ratios=SSD_RATIOS,
        min_sizes=[6.0, 12.0], max_sizes=[12.0, 24.0], steps=[(2.0, 2.0), (4.0, 4.0)],
        kernel_size=3, pad=1)
    idx = match(D.iou_similarity, D.bipartite_match, gt_box, boxes)          # [B, P]
    tgt, _ = D.target_assign(gt_box, idx)
    labels, _ = D.target_assign(gt_label, idx, 0)
    return locs, confs, boxes, var, idx, tgt, labels[..., 0]


def _jax_ssd(image, gt_box, gt_label):
    def match(iou, bm, g, boxes):
        return jax.vmap(lambda gi: bm(iou(gi, boxes))[0])(g)

    locs, confs, boxes, var, idx, tgt, labels = _ssd_head(jL, jD, image, gt_box, gt_label, match)
    enc = jax.vmap(lambda t: jD.box_coder(boxes, var, t))(tgt)
    return {"loss": jD.ssd_loss(locs, confs, enc, labels, (idx >= 0).astype(jnp.float32)),
            "n_priors": boxes.shape[0]}


def _port_ssd(image, gt_box, gt_label):
    def match(iou, bm, g, boxes):
        return bm(iou(g, boxes))[0]

    locs, confs, boxes, var, idx, tgt, labels = _ssd_head(tL, tD, image, gt_box, gt_label, match)
    enc = tD.box_coder(boxes, var, tgt)
    return {"loss": tD.ssd_loss(locs, confs, enc, labels, (idx >= 0).float()),
            "n_priors": boxes.shape[0]}


def test_ssd_head_loss_and_every_grad_through_params_from_jax():
    """The JAX program's param names and shapes (from ``jax.eval_shape`` of
    its init, which would compile every initialiser) equal the port's;
    both run on weights drawn with numpy from a seed, the port's through
    ``params_from_jax``. The JAX side runs eagerly: under ``jax.jit`` XLA
    rounds the IoU of mirrored priors (ratios 2 and 1/2) otherwise and the
    greedy match breaks their ties another way."""
    rng = np.random.RandomState(11)
    feed = {"image": rng.randn(2, 3, 16, 16).astype(np.float32),
            "gt_box": np.stack([_boxes(rng, 3) for _ in range(2)]),
            "gt_label": rng.randint(1, 3, (2, 3, 1)).astype(np.int32)}
    jprog, tprog = jpt.build(_jax_ssd), tpt.build(_port_ssd)
    specs, _ = jax.eval_shape(lambda: jprog.init(jax.random.PRNGKey(0), **feed))
    tprog.init(0, place=CPU, **feed)
    assert {k: tuple(v.shape) for k, v in specs.items()} == \
        {k: tuple(i.shape) for k, i in tprog.param_info.items()}
    assert {k.split("/")[0] for k in specs} == {"feat1", "feat2", "mbox_loc0", "mbox_loc1",
                                                "mbox_conf0", "mbox_conf1"}
    params = {k: (0.3 * rng.randn(*v.shape)).astype(np.float32) for k, v in sorted(specs.items())}

    def jloss(p):
        return jprog.apply(p, {}, **feed)[0]["loss"]

    want, want_g = jax.value_and_grad(jloss)({k: jnp.asarray(v) for k, v in params.items()})
    tparams = params_from_jax(params, tprog.param_info, device="cpu")
    for v in tparams.values():
        v.requires_grad_(True)
    out, _ = tprog.apply(tparams, {}, place=CPU, **feed)
    assert out["n_priors"] == 8 * 8 * 4 + 4 * 4 * 6
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"].detach()), float(want), rtol=1e-5)
    for name, g in want_g.items():
        g = np.asarray(g)
        assert np.abs(tparams[name].grad.numpy() - g).max() <= 1e-4 * np.abs(g).max(), name
