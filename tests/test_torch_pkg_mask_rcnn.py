"""Mask R-CNN R50-FPN: JAX package vs PyTorch port on the CPU, at float32.

Both packages get the same numpy inputs from a seed. The Flax sub-modules
are initialised at 64x96 (jitted inits; the FrozenBN affines drawn at
random so that the fold is exercised) and carried across by
models/mask_rcnn.py::state_dict_from_jax.

Held: ResNet50FPN (P2-P6), RPNHead, BoxHead (with detectron2's box
predictor) and MaskHead within 1e-4 of the largest magnitude;
decode_boxes, clip_boxes, pairwise_iou and roi_align_fpn (boxes on all
four levels, some partly outside the map) within 1e-5; the stable top-k
and nms_keep / batched_nms bit for bit on tests/test_mask_rcnn.py's oracle
cases, on equal scores and on -inf entries; paste_masks and
dynamic_mask_from_detections equal wherever the pasted value is 1e-5 or
more from the 0.5 threshold; the whole forward pass on a 64x96 image with
heads shaped to keep dynamic detections (the same detections); and
load_checkpoint on a pickled detectron2-layout dict against
convert_mask_rcnn_r50fpn on the same dict.

The forward pass turns values into decisions (the score, IoU, level and
paste thresholds), so the whole-forward test asserts that every decision
the port makes on these inputs lies at least MARGIN from its threshold,
ten times the packages' float32 difference in what it compares.
"""

import math
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_cvd_tpu.models import mask_rcnn as JM
from robust_cvd_tpu.models.torch_port import convert_mask_rcnn_r50fpn
from robust_cvd_tpu_torch.device import float32_precision
from robust_cvd_tpu_torch.models import mask_rcnn as TM
from test_mask_rcnn import _detectron2_layout_state, _nms_oracle
from torch_pkg_threads import one_torch_thread  # noqa: F401  (autouse)

H, W = 64, 96
# The least distance of each decision from its threshold on the
# whole-forward inputs: ten times or more the two packages' float32
# difference in what is compared (class probabilities and mask values up
# to ~1e-5 apart after the 50-layer backbone and fc1's 12,544-term sums;
# boxes ~1e-6 px, so IoUs and level values ~1e-7).
MARGIN = {"score": 1e-4, "iou": 1e-5, "level": 1e-5, "paste": 1e-4}
PERSON_BIAS = 6.0  # cls_score bias of class 0: person probabilities ~0.8


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rel, f"max error {err:.3g} of the largest magnitude"


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _flax_params(seed=0):
    """The Flax MaskRCNN params tree at float32, as numpy: each sub-module
    initialised on its own (MaskRCNN.setup names them backbone, rpn,
    box_head, mask_head), FrozenBN scales in [0.5, 1) and biases in
    [-0.1, 0.1)."""
    f32 = jnp.float32
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    feats = [jnp.zeros((1, -(-H // s), -(-W // s), 256)) for s in (4, 8, 16, 32, 64)]
    params = {
        "backbone": jax.jit(JM.ResNet50FPN(dtype=f32).init)(ks[0], jnp.zeros((1, H, W, 3))),
        "rpn": jax.jit(JM.RPNHead(dtype=f32).init)(ks[1], feats),
        "box_head": jax.jit(JM.BoxHead(dtype=f32).init)(ks[2], jnp.zeros((2, 7, 7, 256))),
        "mask_head": jax.jit(JM.MaskHead(dtype=f32).init)(ks[3], jnp.zeros((2, 14, 14, 256))),
    }
    params = jax.tree.map(lambda a: np.array(a, np.float32), {k: v["params"]
                                                               for k, v in params.items()})
    rng = np.random.default_rng(seed)

    def perturb_bn(node):
        for k, v in node.items():
            if isinstance(v, dict) and "scale" in v:
                v["scale"] = rng.uniform(0.5, 1.0, v["scale"].shape).astype(np.float32)
                v["bias"] = rng.uniform(-0.1, 0.1, v["bias"].shape).astype(np.float32)
            elif isinstance(v, dict):
                perturb_bn(v)

    perturb_bn(params["backbone"])
    return params


def _port(params) -> TM.MaskRCNN:
    net = TM.MaskRCNN(dtype=torch.float32).eval()
    net.load_state_dict(TM.state_dict_from_jax(params))
    return net


@pytest.fixture(scope="module")
def nets():
    params = _flax_params()
    return params, _port(params)


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(4).uniform(0, 1, (1, H, W, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def backbone_out(nets, image):
    params, net = nets
    x = (image[..., ::-1] * 255.0 - np.asarray(JM.PIXEL_MEAN_BGR, np.float32)).copy()
    want = jax.jit(JM.ResNet50FPN(dtype=jnp.float32).apply)({"params": params["backbone"]}, x)
    with torch.no_grad(), float32_precision(False):
        got = net.backbone(_nchw(x))
    return got, want


def test_backbone_parity(backbone_out):
    got, want = backbone_out
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _close(g.permute(0, 2, 3, 1), w)


def test_features_match_the_jax_preprocessing(nets, image, backbone_out):
    """MaskRCNN.features: RGB -> BGR, times 255, less the pixel mean."""
    _, net = nets
    with torch.no_grad(), float32_precision(False):
        got = net.features(_nchw(image))
    for g, w in zip(got, backbone_out[1]):
        _close(g.permute(0, 2, 3, 1), w)


def test_rpn_head_parity(nets, backbone_out):
    params, net = nets
    feats = [np.asarray(f) for f in backbone_out[1]]
    want = jax.jit(JM.RPNHead(dtype=jnp.float32).apply)({"params": params["rpn"]}, feats)
    with torch.no_grad(), float32_precision(False):
        got = net.proposal_generator.rpn_head([_nchw(f) for f in feats])
    for (go, gd), (wo, wd) in zip(got, want):
        _close(go.permute(0, 2, 3, 1), wo)
        _close(gd.permute(0, 2, 3, 1), wd)


def test_box_head_parity(nets):
    params, net = nets
    x = np.random.default_rng(1).standard_normal((9, 7, 7, 256)).astype(np.float32)
    ws, wd = JM.BoxHead(dtype=jnp.float32).apply({"params": params["box_head"]}, x)
    with torch.no_grad(), float32_precision(False):
        gs, gd = net.roi_heads.box_predictor(net.roi_heads.box_head(_nchw(x)))
    _close(gs, ws)
    _close(gd, wd)


def test_mask_head_parity(nets):
    params, net = nets
    x = np.random.default_rng(2).standard_normal((3, 14, 14, 256)).astype(np.float32)
    want = JM.MaskHead(dtype=jnp.float32).apply({"params": params["mask_head"]}, x)
    with torch.no_grad(), float32_precision(False):
        got = net.roi_heads.mask_head(_nchw(x))
    _close(got.permute(0, 2, 3, 1), want)


def _random_boxes(rng, n, lo=-20.0, hi=120.0):
    b = rng.uniform(lo, hi, (n, 4)).astype(np.float32)
    b[:, 2:] = b[:, :2] + rng.uniform(1, 60, (n, 2)).astype(np.float32)
    return b


def test_box_math_parity():
    rng = np.random.default_rng(3)
    anchors = _random_boxes(rng, 200)
    deltas = rng.standard_normal((200, 4)).astype(np.float32)
    deltas[:5, 2:] = 20.0  # past SCALE_CLAMP
    for weights in ((1.0, 1.0, 1.0, 1.0), JM.BBOX_REG_WEIGHTS):
        want = np.asarray(JM.decode_boxes(jnp.asarray(anchors), jnp.asarray(deltas), weights))
        got = TM.decode_boxes(torch.from_numpy(anchors), torch.from_numpy(deltas), weights)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    boxes = _random_boxes(rng, 300)
    want = np.asarray(JM.clip_boxes(jnp.asarray(boxes), (H, W)))
    got = TM.clip_boxes(torch.from_numpy(boxes), (H, W))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    other = _random_boxes(rng, 50)
    other[:3] = other[:3, [2, 3, 0, 1]]  # empty boxes
    want = np.asarray(JM.pairwise_iou(jnp.asarray(boxes), jnp.asarray(other)))
    got = TM.pairwise_iou(torch.from_numpy(boxes), torch.from_numpy(other))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_assign_levels_and_anchors_parity():
    rng = np.random.default_rng(8)
    boxes = _random_boxes(rng, 400, hi=600.0) * np.float32(2.0)
    np.testing.assert_array_equal(
        TM.assign_levels(torch.from_numpy(boxes)).numpy(),
        np.asarray(JM.assign_levels(jnp.asarray(boxes))))
    for hw, stride, size in (((16, 24), 4, 32), ((3, 5), 32, 256), ((1, 2), 64, 512)):
        np.testing.assert_array_equal(TM.level_anchors(hw, stride, size).numpy(),
                                      np.asarray(JM.level_anchors(hw, stride, size)))


def test_top_k_tie_order():
    """Equal values and -inf entries come out lower index first, as
    jax.lax.top_k gives them."""
    rng = np.random.default_rng(10)
    x = rng.integers(0, 5, (3, 300)).astype(np.float32)
    x[:, rng.uniform(size=300) < 0.4] = -np.inf
    for k in (1, 37, 150, 300):
        wv, wi = jax.lax.top_k(jnp.asarray(x), k)
        gv, gi = TM.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def _nms_cases():
    rng = np.random.default_rng(1)
    boxes = rng.uniform(0, 80, (64, 4)).astype(np.float32)
    boxes[:, 2:] = boxes[:, :2] + rng.uniform(4, 30, (64, 2))
    yield "oracle", boxes, rng.uniform(0, 1, 64).astype(np.float32), 0.5, None
    n = 64
    chain = np.stack([np.arange(n) * 6.0, np.zeros(n), np.arange(n) * 6.0 + 10.0,
                      np.full(n, 10.0)], axis=-1).astype(np.float32)
    yield "chain", chain, np.linspace(1.0, 0.5, n).astype(np.float32), 0.2, None
    rng = np.random.default_rng(7)
    dense = rng.uniform(0, 60, (500, 4)).astype(np.float32)
    dense[:, 2:] = dense[:, :2] + rng.uniform(8, 40, (500, 2))
    yield ("dense_valid", dense, rng.uniform(0, 1, 500).astype(np.float32), 0.5,
           rng.uniform(0, 1, 500) > 0.3)
    # ties: four score levels, and a third of the entries at -inf
    rng = np.random.default_rng(11)
    tied = rng.integers(0, 4, 300).astype(np.float32) / 4
    tied[rng.uniform(size=300) < 0.33] = -np.inf
    yield "ties_inf", _random_boxes(rng, 300, 0.0, 60.0), tied, 0.5, None
    yield "ties_inf_valid", _random_boxes(rng, 300, 0.0, 60.0), tied, 0.7, np.isfinite(tied)


@pytest.mark.parametrize("case", [c[0] for c in _nms_cases()])
def test_nms_keep_bitwise(case):
    _, boxes, scores, thresh, valid = next(c for c in _nms_cases() if c[0] == case)
    want = np.asarray(JM.nms_keep(jnp.asarray(boxes), jnp.asarray(scores), thresh,
                                  valid=None if valid is None else jnp.asarray(valid)))
    got = TM.nms_keep(torch.from_numpy(boxes), torch.from_numpy(scores), thresh,
                      valid=None if valid is None else torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    if np.isfinite(scores).all():
        v = np.ones(len(boxes), bool) if valid is None else valid
        oracle = np.zeros(len(boxes), bool)
        oracle[np.flatnonzero(v)] = _nms_oracle(boxes[v], scores[v], thresh)
        np.testing.assert_array_equal(got, oracle)


def test_nms_batched_leading_axes():
    """nms_keep and batched_nms over a leading batch axis equal their
    per-entry calls, and batched_nms equals the JAX package's."""
    cases = [c for c in _nms_cases() if c[0] in ("ties_inf", "ties_inf_valid")]
    boxes = np.stack([c[1] for c in cases])
    scores = np.stack([c[2] for c in cases])
    idxs = np.random.default_rng(12).integers(0, 3, scores.shape)
    got = TM.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                         torch.from_numpy(idxs), 0.5).numpy()
    for b in range(len(cases)):
        want = np.asarray(JM.batched_nms(jnp.asarray(boxes[b]), jnp.asarray(scores[b]),
                                         jnp.asarray(idxs[b]), 0.5))
        np.testing.assert_array_equal(got[b], want)
        one = TM.batched_nms(torch.from_numpy(boxes[b]), torch.from_numpy(scores[b]),
                             torch.from_numpy(idxs[b]), 0.5).numpy()
        np.testing.assert_array_equal(one, want)


def test_roi_align_fpn_parity():
    """Boxes on all four levels, some hanging out of the map, at both
    output sizes; roi_align_level against the JAX one too."""
    rng = np.random.default_rng(9)
    h0, w0 = 64, 96
    feats = [rng.standard_normal((1, h0 // 2 ** i, w0 // 2 ** i, 5)).astype(np.float32)
             for i in range(5)]
    boxes = np.asarray([[4, 4, 36, 36], [0, 0, 100, 100], [-8, -8, 200, 220],
                        [0, 0, 380, 250], [360, 240, 383, 255], [-30, 200, 60, 300],
                        [-40, -20, 500, 480]],
                       np.float32)
    boxes = np.concatenate([boxes, _random_boxes(rng, 30, -40.0, 300.0) * np.float32(1.5)])
    levels = np.asarray(JM.assign_levels(jnp.asarray(boxes)))
    assert set(levels.tolist()) == {2, 3, 4, 5}
    tfeats = [_nchw(f) for f in feats]
    for out in (7, 14):
        want = np.asarray(JM.roi_align_fpn([jnp.asarray(f) for f in feats],
                                           jnp.asarray(boxes), out))
        got = TM.roi_align_fpn(tfeats, torch.from_numpy(boxes)[None], out)[0]
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5, atol=1e-5)
    want = np.asarray(JM.roi_align_level(jnp.asarray(feats[1][0]), jnp.asarray(boxes), 7, 8.0))
    got = TM.roi_align_level(tfeats[1][0], torch.from_numpy(boxes), 7, 8.0)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5, atol=1e-5)


def _paste_values(masks, boxes, hw):
    """The paste's continuous values in float64 (numpy), for the margin."""
    h, w = hw
    ms = masks.shape[-1]
    x = np.arange(w) + 0.5
    y = np.arange(h) + 0.5
    b = boxes.astype(np.float64)
    bw = np.maximum(b[:, 2] - b[:, 0], 1e-6)
    bh = np.maximum(b[:, 3] - b[:, 1], 1e-6)
    mx = (x[None] - b[:, :1]) / bw[:, None] * ms - 0.5
    my = (y[None] - b[:, 1:2]) / bh[:, None] * ms - 0.5
    k = np.arange(ms)
    wy = np.maximum(0, 1 - np.abs(my[..., None] - k))
    wx = np.maximum(0, 1 - np.abs(mx[..., None] - k))
    return np.einsum("dhk,dkl,dwl->dhw", wy, masks.astype(np.float64), wx)


def test_paste_masks_parity():
    rng = np.random.default_rng(13)
    hw = (48, 80)
    masks = rng.uniform(0, 1, (12, 28, 28)).astype(np.float32)
    boxes = _random_boxes(rng, 12, -10.0, 70.0)
    want = np.asarray(JM.paste_masks(jnp.asarray(masks), jnp.asarray(boxes), hw))
    got = TM.paste_masks(torch.from_numpy(masks), torch.from_numpy(boxes), hw).numpy()
    away = np.abs(_paste_values(masks, boxes, hw) - 0.5) >= 1e-5
    assert away.mean() > 0.99 and want.any()
    np.testing.assert_array_equal(got[away], want[away])


def test_dynamic_mask_from_detections_parity():
    """Dynamic and static classes, scores on both sides of the threshold
    (0.1 or more from it), a batch axis on the port's side."""
    rng = np.random.default_rng(14)
    hw = (40, 56)
    d = 20
    det = {"boxes": _random_boxes(rng, d, -5.0, 50.0),
           "scores": rng.choice([0.0, 0.3, 0.62, 0.9], d).astype(np.float32),
           "classes": rng.integers(0, 80, d).astype(np.int32),
           "masks": rng.uniform(0, 1, (d, 28, 28)).astype(np.float32)}
    det["classes"][:4] = [0, 5, 14, 30]
    det["scores"][:4] = 0.9
    want = np.asarray(JM.dynamic_mask_from_detections(
        {k: jnp.asarray(v) for k, v in det.items()}, hw))
    tdet = {k: torch.from_numpy(v)[None].expand(2, *v.shape) for k, v in det.items()}
    tdet["classes"] = tdet["classes"].long()
    got = TM.dynamic_mask_from_detections(tdet, hw).numpy()
    vals = _paste_values(det["masks"], det["boxes"], hw)
    sel = np.isin(det["classes"], JM.DYNAMIC_OBJECT_CATEGORIES) & (det["scores"] > 0.5)
    near = (np.abs(vals - 0.5) < 1e-5) & sel[:, None, None]
    away = ~near.any(0)
    assert away.mean() > 0.99 and want.any() and not want.all()
    for b in range(2):
        np.testing.assert_array_equal(got[b][away], want[away])


def _shaped(params):
    """The heads shaped to give dynamic detections: class 0 (person) gets
    PERSON_BIAS and the class scores a tenth of their weights, so every
    proposal scores person at ~0.8; the mask predictor's class 0 gets a
    bias of 0.5; the RPN's and the box head's deltas a hundredth of their
    weights, so that boxes stay near their anchors and inside the image."""
    p = jax.tree.map(np.copy, params)
    p["rpn"]["anchor_deltas"]["kernel"] *= np.float32(0.01)
    p["box_head"]["bbox_pred"]["kernel"] *= np.float32(0.01)
    cls = p["box_head"]["cls_score"]
    cls["kernel"] *= np.float32(0.1)
    cls["bias"][0] = PERSON_BIAS
    p["mask_head"]["predictor"]["bias"][0] = 0.5
    return p


def _level_decisions(net, feats, hw):
    """What the port decides on its way to the detections, in float64:
    (RPN IoU margins to RPN_NMS_THRESH over the pairs greedy NMS compares
    with a kept box, the proposals)."""
    rpn_out = net.proposal_generator.rpn_head(feats)
    margins = []
    for i, (obj, deltas) in enumerate(rpn_out):
        fh, fw = obj.shape[-2:]
        anchors = TM.level_anchors((fh, fw), 4 * 2 ** i, TM.ANCHOR_SIZES[i])
        scores = obj.permute(0, 2, 3, 1).reshape(-1)
        d = deltas.permute(0, 2, 3, 1).reshape(-1, 4)
        s, idx = TM.top_k(scores, min(TM.RPN_PRE_NMS_TOPK, scores.shape[0]))
        boxes = TM.clip_boxes(TM.decode_boxes(anchors[idx], d[idx]), hw)
        keep = TM.nms_keep(boxes, s, TM.RPN_NMS_THRESH)
        margins.append(_iou_margin(boxes, s, keep, TM.RPN_NMS_THRESH))
    return min(margins)


def _iou_margin(boxes, scores, keep, thresh, valid=None):
    """min |IoU - thresh| over the pairs (j kept, i after j in score
    order, both valid): the comparisons that decide greedy NMS."""
    order = torch.sort(scores, descending=True, stable=True).indices
    b = boxes[order].double()
    k = keep[order]
    v = torch.ones_like(k) if valid is None else valid[order]
    iou = TM.pairwise_iou(b, b)
    n = len(order)
    pairs = (torch.ones(n, n, dtype=torch.bool).triu(1) & (k & v)[:, None] & v[None, :])
    return float((iou - thresh).abs()[pairs].min()) if pairs.any() else math.inf


def _level_margin(boxes):
    area = ((boxes[..., 2] - boxes[..., 0]).clamp(min=0)
            * (boxes[..., 3] - boxes[..., 1]).clamp(min=0)).double()
    v = 4 + torch.log2(torch.sqrt(area) / 224.0 + 1e-9)
    v = v[(v > 2.5) & (v < 5.5)]  # only the 2|3, 3|4 and 4|5 boundaries decide
    return float((v - v.round()).abs().min()) if v.numel() else math.inf


@pytest.fixture(scope="module")
def forward(nets):
    params = _shaped(nets[0])
    net = _port(params)
    img = np.random.default_rng(15).uniform(0, 1, (1, H, W, 3)).astype(np.float32)
    jdet = jax.jit(JM.MaskRCNN(dtype=jnp.float32).apply)({"params": params}, jnp.asarray(img))
    with torch.no_grad(), float32_precision(False):
        x = _nchw(img)
        tdet = net(x)
        feats = net.features(x)
        rpn_margin = _level_decisions(net, feats, (H, W))
        props = net.proposals(feats, (H, W))
        cls_logits, box_deltas = net.box_outputs(feats, props)
    return dict(jdet={k: np.asarray(v) for k, v in jdet.items()},
                tdet={k: v[0].numpy() for k, v in tdet.items()}, rpn_margin=rpn_margin,
                props=props[0], probs=torch.softmax(cls_logits[0], -1)[:, :-1],
                box_deltas=box_deltas[0])


def test_forward_decisions_have_margin(forward):
    """Every decision of the port's forward lies MARGIN or more from its
    threshold on these inputs, so the float32 difference of the two
    packages cannot flip one."""
    assert forward["rpn_margin"] >= MARGIN["iou"]
    probs = forward["probs"]
    assert (probs - TM.ROI_SCORE_THRESH).abs().min() >= MARGIN["score"]
    det = forward["tdet"]
    valid = det["scores"] > 0
    assert _level_margin(forward["props"]) >= MARGIN["level"]
    assert _level_margin(torch.from_numpy(det["boxes"][valid])) >= MARGIN["level"]
    # ROI NMS: the candidates, as detect() forms them
    props, r = forward["props"], forward["props"].shape[0]
    boxes = TM.clip_boxes(TM.decode_boxes(props[:, None], forward["box_deltas"].reshape(r, 80, 4),
                                          TM.BBOX_REG_WEIGHTS), (H, W)).reshape(-1, 4)
    flat = probs.reshape(-1)
    s, idx = TM.top_k(torch.where(flat > 0.5, flat, -math.inf), 1000)
    cls = torch.arange(80).repeat(r)[idx]
    cand = boxes[idx] + cls[:, None].float() * (boxes[idx].max() + 1.0)
    keep = TM.nms_keep(cand, s, TM.ROI_NMS_THRESH, valid=torch.isfinite(s))
    assert _iou_margin(cand, s, keep, TM.ROI_NMS_THRESH,
                       valid=torch.isfinite(s)) >= MARGIN["iou"]


def test_forward_parity(forward):
    """The same detections (boxes, scores, classes, masks) from both
    packages, at least one of them dynamic, and the same dynamic mask."""
    j, t = forward["jdet"], forward["tdet"]
    valid = j["scores"] > 0
    np.testing.assert_array_equal(t["scores"] > 0, valid)
    dyn = valid & np.isin(j["classes"], JM.DYNAMIC_OBJECT_CATEGORIES)
    assert dyn.sum() >= 1
    np.testing.assert_array_equal(t["classes"][valid], j["classes"][valid])
    np.testing.assert_allclose(t["scores"], j["scores"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(t["boxes"][valid], j["boxes"][valid], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(t["masks"][valid], j["masks"][valid], rtol=1e-4, atol=1e-5)
    want = np.asarray(JM.dynamic_mask_from_detections(
        {k: jnp.asarray(v) for k, v in j.items()}, (H, W)))
    got = TM.dynamic_mask_from_detections(
        {k: torch.from_numpy(v)[None] for k, v in t.items()}, (H, W))[0].numpy()
    assert want.any() and not want.all()
    # the paste's threshold: pixels whose value in a detection is within
    # MARGIN of 0.5 may differ
    near = (np.abs(_paste_values(t["masks"][dyn], t["boxes"][dyn], (H, W)) - 0.5)
            < MARGIN["paste"]).any(0)
    assert near.mean() < 0.01
    np.testing.assert_array_equal(got[~near], want[~near])


def test_load_checkpoint_matches_convert(tmp_path):
    """A pickled detectron2-layout dict (the zoo's {"model": ...} layout,
    float64 arrays as some pickles hold) gives the port through
    load_checkpoint / load_weights_ the same backbone and heads as the JAX
    package through convert_mask_rcnn_r50fpn; FrozenBN statistics away
    from identity, so the two folds are compared."""
    rng = np.random.default_rng(5)
    sd = _detectron2_layout_state(rng)
    for k in sd:
        if k.endswith("norm.running_var"):
            sd[k] = rng.uniform(0.5, 2.0, sd[k].shape).astype(np.float32)
        elif k.endswith("norm.running_mean") or k.endswith("norm.bias"):
            sd[k] = rng.uniform(-0.2, 0.2, sd[k].shape).astype(np.float32)
    sd["roi_heads.box_head.fc1.weight"] = sd["roi_heads.box_head.fc1.weight"].astype(np.float64)
    path = tmp_path / "model_final.pkl"
    with open(path, "wb") as f:
        pickle.dump({"model": sd, "__author__": "test"}, f)
    params = convert_mask_rcnn_r50fpn(sd)
    net = TM.load_weights_(TM.MaskRCNN(dtype=torch.float32).eval(), TM.load_checkpoint(str(path)))
    for name, m in net.named_modules():
        if isinstance(m, TM.FrozenBN) and name.endswith("res3.1.conv2.norm"):
            # one float32 fold each; numpy's and torch's CPU square roots
            # round a few values to neighbouring floats
            scale, bias = m.folded()
            jn = params["backbone"]["res3_1"]["bn2"]
            np.testing.assert_allclose(scale.numpy(), jn["scale"], rtol=2.5e-7, atol=0)
            np.testing.assert_allclose(bias.numpy(), jn["bias"], rtol=0, atol=1e-7)
    x = np.random.default_rng(6).uniform(-100, 100, (1, 64, 64, 3)).astype(np.float32)
    want = JM.ResNet50FPN(dtype=jnp.float32).apply({"params": params["backbone"]}, x)
    with torch.no_grad(), float32_precision(False):
        got = net.backbone(_nchw(x))
    for g, w in zip(got, want):
        _close(g.permute(0, 2, 3, 1), w)
    pooled = np.random.default_rng(7).standard_normal((5, 7, 7, 256)).astype(np.float32)
    ws, wd = JM.BoxHead(dtype=jnp.float32).apply({"params": params["box_head"]}, pooled)
    with torch.no_grad(), float32_precision(False):
        gs, gd = net.roi_heads.box_predictor(net.roi_heads.box_head(_nchw(pooled)))
    _close(gs, ws)
    _close(gd, wd)
    del sd["roi_heads.mask_head.predictor.bias"]
    with pytest.raises(KeyError, match="predictor.bias"):
        TM.load_weights_(TM.MaskRCNN(dtype=torch.float32), sd)
