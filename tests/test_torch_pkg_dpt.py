"""DPT-Large (robust_cvd_tpu_torch/models/dpt.py) on the CPU against the
plain reference tests/plain_dpt.py, at a small size: hidden 64, 4 heads of
16, 4 blocks hooked at 0-3, an MLP of 256, reassembly widths 16/32/64/64,
features 32, a 64x96 input (a 4x6 token grid), and a 4x4 position grid
resized to 4x6. Seeded weights (plain_dpt.seeded_state_dict) load into both
nets by the checkpoint's keys.

- The forward agrees in float64 (within 1e-12 of the largest depth) and
  in float32 (within 1e-5).
- One FineTuner.train_step in float64 agrees with the plain step (the
  plain net, the port's joint loss, Adam written out): the loss within
  1e-10 relative, every gradient within 1e-9 of the largest, every
  parameter after the update within 1e-3 lr.
- The two traps of a decoder shared with MiDaS v2: the residual units add
  x, not relu(x), and the head upsamples with align_corners=True; putting
  MiDaS v2's choice back moves the output away from the plain reference.
- The state-dict keys are MiDaS v3.0's, with DPT-Large's shapes and
  parameter count.
- The registry gives DPTLargeAdapter for `dpt_large`, _depth_model follows
  cfg.model_type, and a missing checkpoint names its file and variable; a
  third model, a DepthModel defined in the test and registered there,
  loads, trains a step and infers with no file of the port edited.
- MiDaS v2's outputs and gradients are bit for bit what the blocks gave
  before they were shared.
- TF32 matrix products are scoped to the DPT adapter and to callers that
  allow TF32; the four DPT spans sit inside train.forward; the CLI runs
  `--model_type dpt_large` end to end.
"""

import functools
import math
import os

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

import plain_dpt
from torch_pkg_threads import one_torch_thread  # noqa: F401

from robust_cvd_tpu_torch.config import FineTuneParams, PipelineConfig
from robust_cvd_tpu_torch.models import depth_model, dpt, layers, midas, registry
from robust_cvd_tpu_torch.pipeline.process import DatasetProcessor
from robust_cvd_tpu_torch.training import fine_tune
from robust_cvd_tpu_torch.training.fine_tune import FineTuner, PoseState, build_clip_data
from robust_cvd_tpu_torch.utils import spans

SMALL = dict(hidden=64, heads=4, blocks=4, mlp=256, patch=16, pos_grid=4, hooks=(0, 1, 2, 3),
             widths=(16, 32, 64, 64), features=32, classes=10)
N, H, W = 4, 64, 96
LR = 1e-4


def _nets(seed=3, dtype=torch.float32, head_scale=True):
    ref = plain_dpt.DPT(**SMALL)
    sd = plain_dpt.seeded_state_dict(ref, seed)
    if not head_scale:  # the head's raw output, not 2 + 0.01 of it
        sd["scratch.output_conv.4.weight"].mul_(100.0)
        sd["scratch.output_conv.4.bias"].zero_()
    ref.load_state_dict(sd)
    port = dpt.DPTDepthNet(**SMALL)
    port.load_state_dict(sd)
    return port.to(dtype).eval(), ref.to(dtype).eval()


def _images(dtype=torch.float32, n=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, H, W, 3), generator=g, dtype=torch.float64).to(dtype)


@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_forward_matches_the_plain_reference(dtype, tol):
    port, ref = _nets(dtype=dtype)
    x = _images(dtype)
    with torch.no_grad():
        want = plain_dpt.depth(ref, x)
        got = depth_model.depth_apply(port, x)
        assert got.dtype == dtype and got.shape == (2, H, W)
        assert (got - want).abs().max() <= tol * want.abs().max()
        # the raw disparity too, where the seeded head does not squash it
        port, ref = _nets(dtype=dtype, head_scale=False)
        want = ref(plain_dpt.normalize(x))
        got = port(dpt.normalize_images(x).permute(0, 3, 1, 2))
        assert want.std() > 0.1 and (got - want).abs().max() <= tol * want.abs().max()


@pytest.mark.parametrize("choice", ["residual_unit_skip", "head_align_corners"])
def test_midas_v2_choices_do_not_leak_into_dpt(choice):
    """DPT's residual units add x and its head upsamples with
    align_corners=True; MiDaS v2's units add relu(x) and its head uses
    align_corners=False. Each of MiDaS v2's choices, put into the DPT net,
    moves its output far from the plain reference."""
    port, ref = _nets(dtype=torch.float64, head_scale=False)
    units = [m for m in port.modules() if isinstance(m, layers.ResidualConvUnit)]
    assert len(units) == 8
    head_up = port.scratch.output_conv[1]
    assert all(not u.relu_skip for u in units) and head_up.align_corners is True
    mid = midas.MidasNet(features=8, backbone_layers=(1, 1, 1, 1))
    assert all(m.relu_skip for m in mid.modules() if isinstance(m, layers.ResidualConvUnit))
    assert mid.scratch.output_conv[1].align_corners is False

    # a unit with zero convolutions returns its skip: x for DPT
    unit = layers.ResidualConvUnit(3, relu_skip=False)
    for p in unit.parameters():
        torch.nn.init.zeros_(p)
    x = torch.randn(1, 3, 4, 4)
    assert torch.equal(unit(x), x) and (x < 0).any()

    xin = plain_dpt.normalize(_images(torch.float64))
    with torch.no_grad():
        want = ref(xin)
        assert (port(xin) - want).abs().max() <= 1e-12 * want.abs().max()
        if choice == "residual_unit_skip":
            for u in units:
                u.relu_skip = True
        else:
            head_up.align_corners = False
        assert (port(xin) - want).abs().max() > 1e-3 * want.abs().max()


def _full_keys():
    """DPT-Large's state-dict keys as MiDaS v3.0's checkpoint names them,
    with the shapes of the ones that carry the widths."""
    wb = (".weight", ".bias")
    keys = {"pretrained.model.cls_token": (1, 1, 1024),
            "pretrained.model.pos_embed": (1, 577, 1024),
            "pretrained.model.patch_embed.proj.weight": (1024, 3, 16, 16),
            "pretrained.model.patch_embed.proj.bias": None,
            "pretrained.model.head.weight": (1000, 1024)}
    for n in range(24):
        for m in ("norm1", "attn.qkv", "attn.proj", "norm2", "mlp.fc1", "mlp.fc2"):
            for s in wb:
                keys[f"pretrained.model.blocks.{n}.{m}{s}"] = None
    keys["pretrained.model.blocks.0.attn.qkv.weight"] = (3072, 1024)
    keys["pretrained.model.blocks.23.mlp.fc1.weight"] = (4096, 1024)
    for s in wb:
        keys["pretrained.model.norm" + s] = None
    keys["pretrained.model.head.bias"] = (1000,)
    for level in range(1, 5):
        for m in ("0.project.0", "3") + (("4",) if level != 3 else ()):
            for s in wb:
                keys[f"pretrained.act_postprocess{level}.{m}{s}"] = None
        keys[f"scratch.layer{level}_rn.weight"] = None
        fusion = [f"{u}.{c}" for u in ("resConfUnit1", "resConfUnit2") for c in ("conv1", "conv2")]
        for m in fusion + ["out_conv"]:
            k = 1 if m == "out_conv" else 3
            keys[f"scratch.refinenet{level}.{m}.weight"] = (256, 256, k, k)
            keys[f"scratch.refinenet{level}.{m}.bias"] = (256,)
    keys.update({"pretrained.act_postprocess1.0.project.0.weight": (1024, 2048),
                 "pretrained.act_postprocess1.4.weight": (256, 256, 4, 4),
                 "pretrained.act_postprocess2.4.weight": (512, 512, 2, 2),
                 "pretrained.act_postprocess3.3.weight": (1024, 1024, 1, 1),
                 "pretrained.act_postprocess4.4.weight": (1024, 1024, 3, 3),
                 "scratch.layer1_rn.weight": (256, 256, 3, 3),
                 "scratch.layer4_rn.weight": (256, 1024, 3, 3)})
    for k, shape in zip((0, 2, 4), ((128, 256, 3, 3), (32, 128, 3, 3), (1, 32, 1, 1))):
        keys[f"scratch.output_conv.{k}.weight"] = shape
        keys[f"scratch.output_conv.{k}.bias"] = shape[:1]
    return keys


def test_state_dict_keys_are_midas_v3s():
    with torch.device("meta"):
        net = dpt.DPTDepthNet()
    sd = net.state_dict()
    want = _full_keys()
    assert sorted(sd) == sorted(want)
    for k, shape in want.items():
        if shape is not None:
            assert tuple(sd[k].shape) == shape, k
    assert sum(p.numel() for p in net.parameters()) == 344_055_465
    small = plain_dpt.DPT(**SMALL)
    assert sorted(dpt.DPTDepthNet(**SMALL).state_dict()) == sorted(small.state_dict())


def test_the_registry_gives_dpt_large():
    assert registry.get_depth_model("dpt_large") is dpt.DPTLargeAdapter
    assert registry.get_depth_model("midas2") is midas.MidasV2Adapter
    assert {"midas2", "dpt_large"} <= set(registry.get_depth_model_list())
    a = dpt.DPTLargeAdapter
    assert (a.align, a.learning_rate, a.lambda_view_baseline) == (32, 1e-6, 1e-4)
    assert (a.checkpoint, a.checkpoint_env) == ("dpt_large-midas-2f21e586.pt", "DPT_CHECKPOINT")
    x = torch.tensor([0.0, 0.25, 1.0])
    # the normalisation travels with the net, so no caller can mix them up
    assert torch.equal(dpt.DPTDepthNet.normalize(x), torch.tensor([-1.0, -0.5, 1.0]))
    assert midas.MidasNet.normalize is midas.normalize_images
    with pytest.raises(KeyError, match="dpt_large"):
        registry.get_depth_model("no_such_model")


class _ToyNet(nn.Module):
    """Two convolutions to a disparity in (1, 2), with an input
    normalisation of its own."""

    @staticmethod
    def normalize(images):
        return images * 2.0 - 1.0

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 4, 3, padding=1)
        self.conv2 = nn.Conv2d(4, 1, 3, padding=1)

    def forward(self, x):
        return 1.0 + torch.sigmoid(self.conv2(F.relu(self.conv1(x))))[:, 0]


class _ToyAdapter(depth_model.DepthModel):
    """A third depth model, filled in from the contract alone."""

    align = 16
    learning_rate = 1e-4
    lambda_view_baseline = 1e-4
    checkpoint = "toy_depth.pt"
    checkpoint_env = "TOY_DEPTH_CHECKPOINT"

    @staticmethod
    def new_net():
        return _ToyNet()


@pytest.mark.parametrize("model_type", ["dpt_large", "midas2", "toy"])
def test_depth_model_follows_the_model_type(model_type, tmp_path, monkeypatch):
    """_depth_model builds the adapter cfg.model_type names from
    <path>/models/<its checkpoint>, or from its environment variable, and
    a missing checkpoint raises naming both. The toy model, registered
    here, also takes a train step and infers the clip's depth."""
    if model_type == "toy":
        monkeypatch.setattr(registry, "_REGISTRY", dict(registry._REGISTRY))
        cls = registry.register("toy")(_ToyAdapter)
        torch.manual_seed(0)
        net = _ToyNet()
        blob = net.state_dict()
    elif model_type == "dpt_large":
        monkeypatch.setattr(dpt, "DPTDepthNet", functools.partial(dpt.DPTDepthNet, **SMALL))
        net, cls = _nets()[0], dpt.DPTLargeAdapter
        # MiDaS's {"model", "optimizer"} layout loads too
        blob = {"model": net.state_dict(), "optimizer": {}}
    else:
        monkeypatch.setattr(midas, "MidasNet", functools.partial(
            midas.MidasNet, features=8, backbone_layers=(1, 1, 1, 1)))
        net, cls = midas.seeded_init_(midas.MidasNet(), 0), midas.MidasV2Adapter
        # a DataParallel checkpoint under "state_dict" loads too
        blob = {"state_dict": {"module." + k: v for k, v in net.state_dict().items()}}
    monkeypatch.delenv(cls.checkpoint_env, raising=False)
    cfg = PipelineConfig(path=str(tmp_path), model_type=model_type)
    with pytest.raises(FileNotFoundError) as e:
        DatasetProcessor(cfg, device="cpu")._depth_model()
    assert cls.checkpoint in str(e.value) and cls.checkpoint_env in str(e.value)

    elsewhere = tmp_path / "weights.pt"
    torch.save(blob, elsewhere)
    monkeypatch.setenv(cls.checkpoint_env, str(elsewhere))
    adapter = DatasetProcessor(cfg, device="cpu")._depth_model()
    assert type(adapter) is cls
    for k, v in net.state_dict().items():
        assert torch.equal(adapter.net.state_dict()[k], v), k
    if model_type == "toy":
        tuner, _ = _tuner(dtype=torch.float32, adapter=adapter)
        loss, _, ok = tuner.train_step(torch.tensor([0, 2]))
        depth = tuner.infer_depth(batch=2)
        assert bool(ok) and math.isfinite(float(loss))
        assert depth.shape == (N, H, W) and torch.isfinite(depth).all() and (depth > 0).all()


def _tuner(dtype=torch.float64, seed=0, cudnn_tf32=False, adapter=None, device="cpu"):
    """A FineTuner of the small DPT (or of `adapter`) on an N-frame clip:
    seeded images, depths, flows and masks, and a seeded pose state;
    everything in `dtype`, on `device`."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (N, H, W, 3)).astype(np.float32)
    depth = rng.uniform(1, 3, (N, H, W)).astype(np.float32)
    flow_list, flows, masks = [], {}, {}
    for i in range(N):
        for j in range(N):
            if i != j and abs(i - j) <= 2:
                flow_list.append((i, j, 0.9))
                flows[(i, j)] = rng.normal(0, 1, (H, W, 2)).astype(np.float32)
                masks[(i, j)] = (rng.uniform(0, 1, (H, W)) > 0.3).astype(np.float32)
    clip = build_clip_data(images, depth, flow_list, flows, masks, 0.2, device=device)
    clip = clip._replace(**{k: v.to(dtype) for k, v in clip._asdict().items()
                            if v is not None and v.is_floating_point()})
    angles = rng.normal(0, 0.01, (N, 3))
    ext = np.zeros((N, 3, 4))
    for i, (a, b, c) in enumerate(angles):
        rz = np.array([[math.cos(c), -math.sin(c), 0], [math.sin(c), math.cos(c), 0], [0, 0, 1]])
        ry = np.array([[math.cos(b), 0, math.sin(b)], [0, 1, 0], [-math.sin(b), 0, math.cos(b)]])
        ext[i, :, :3] = rz @ ry
        ext[i, :, 3] = [0.02 * i, rng.normal(0, 0.002), rng.normal(0, 0.002)]
    f = W / 2 / math.tan(math.radians(30))
    ps = PoseState(
        extrinsics=torch.tensor(ext, dtype=dtype, device=device),
        intrinsics=torch.tensor([[f, f, (W - 1) / 2, (H - 1) / 2]] * N, dtype=dtype,
                                device=device),
        scales=torch.tensor(rng.uniform(0.9, 1.1, (N, H, W)), dtype=dtype, device=device),
        warp=torch.tensor(rng.normal(0, 0.002, (N, H, W, 2)), dtype=dtype, device=device),
    )
    port, ref = _nets(dtype=dtype)
    cfg = PipelineConfig(ft=FineTuneParams(save_tensorboard=False, learning_rate=LR))
    tuner = FineTuner(cfg, adapter or dpt.DPTLargeAdapter(port), clip, None, device=device,
                      cudnn_tf32=cudnn_tf32)
    tuner.pose_state = ps
    return tuner, ref


def test_one_train_step_matches_the_plain_step():
    """FineTuner.train_step (the DPT adapter's normalisation, FlatAdam) in
    float64 against the plain net, the same joint loss and Adam's first
    step written out."""
    tuner, ref = _tuner()
    ids = torch.tensor([0, 2])
    frames, images, meta = fine_tune._batch(ids, tuner.clip, tuner.pose_state, False)
    b, k = frames.shape
    ref.train()
    d = plain_dpt.depth(ref, images.reshape(b * k, H, W, 3)).reshape(b, k, H, W)
    d = d * tuner.pose_state.scales[frames]
    want, _ = fine_tune.losses.joint_loss(tuner.cfg.loss, images, tuner.clip.depth_orig[frames],
                                          d, meta)
    want.backward()
    grads = {n: p.grad for n, p in ref.named_parameters()}
    before = {n: p.detach().clone() for n, p in ref.named_parameters()}

    loss, _, ok = tuner.train_step(ids)
    want = float(want.detach())
    assert bool(ok) and abs(float(loss) - want) <= 1e-10 * abs(want)
    opt = tuner.optimizer
    got = opt.named_views(opt.grad)
    top = max(float(g.abs().max()) for g in grads.values() if g is not None)
    assert top > 0
    # the final LayerNorm and the classifier are not run; refinenet4 takes
    # no skip
    assert {n for n, g in grads.items() if g is None} == {
        n for n in grads if n.startswith(("pretrained.model.norm.", "pretrained.model.head.",
                                          "scratch.refinenet4.resConfUnit1."))}
    for n, g in grads.items():
        g = torch.zeros_like(before[n]) if g is None else g
        assert (got[n] - g).abs().max() <= 1e-9 * top, n
        # Adam's first step: p - lr * g / (|g| + eps)
        step = before[n] - LR * g / (g.abs() + 1e-8)
        assert (opt.named_views(opt.flat)[n] - step).abs().max() <= 1e-3 * LR, n


def _record_precision(net, seen):
    net.register_forward_hook(lambda *_: seen.append(torch.get_float32_matmul_precision()))


def test_tf32_matrix_products_are_scoped_to_the_dpt_adapter(monkeypatch):
    """The DPT net's forward runs with TF32 matrix products ("high") in the
    train step and the adapter's inference, MiDaS v2's with "highest"; the
    caller's setting comes back afterwards. A tuner built without TF32,
    and the adapter's inference with cuDNN's TF32 off, keep DPT in full
    float32."""
    seen = []
    tuner, _ = _tuner(dtype=torch.float32, cudnn_tf32=True)
    _record_precision(tuner.net, seen)
    old = torch.get_float32_matmul_precision()
    tuner.train_step(torch.tensor([0, 1]))
    tuner.adapter.estimate_depth(tuner.clip.images[:1])
    tuner.infer_depth(batch=2)
    assert seen == ["high"] * 4 and torch.get_float32_matmul_precision() == old
    seen.clear()
    with monkeypatch.context() as m:
        m.setattr(torch.backends.cudnn, "allow_tf32", False)
        tuner.adapter.estimate_depth(tuner.clip.images[:1])
    assert seen == ["highest"]
    seen.clear()
    plain, _ = _tuner(dtype=torch.float32, cudnn_tf32=False)
    _record_precision(plain.net, seen)
    plain.train_step(torch.tensor([0, 1]))
    plain.infer_depth(batch=2)
    assert seen == ["highest"] * 3 and torch.get_float32_matmul_precision() == old
    assert midas.MidasV2Adapter.matmul_tf32 is False and dpt.DPTLargeAdapter.matmul_tf32


def test_dpt_spans_sit_inside_the_forward():
    tuner, _ = _tuner(dtype=torch.float32)
    tuner.train_step(torch.tensor([0, 1]))
    (step,) = spans.recent("train.step", 1)
    (fwd,) = [c for c in step["children"] if c["name"] == "train.forward"]
    names = [c["name"] for c in fwd["children"]]
    assert names == ["dpt.embed", "dpt.encoder", "dpt.reassemble", "dpt.decoder"]
    enc = fwd["children"][1]
    assert enc["attrs"] == {"tokens": 1 + (H // 16) * (W // 16), "frames": 4}


def _old_midas_blocks(monkeypatch):
    """The MiDaS v2 blocks' forwards as they were before DPT shared them."""

    def rcu(self, x):
        x = F.relu(x)
        return self.conv2(F.relu(self.conv1(x))) + x

    def fusion(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        return F.interpolate(self.resConfUnit2(x), scale_factor=2, mode="bilinear",
                             align_corners=True)

    def up(self, x):
        return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)

    monkeypatch.setattr(layers.ResidualConvUnit, "forward", rcu)
    monkeypatch.setattr(layers.FeatureFusionBlock, "forward", fusion)
    monkeypatch.setattr(layers._Upsample2x, "forward", up)


def test_midas_v2_is_bit_for_bit_unchanged(monkeypatch):
    """MiDaS v2's depth in eval mode and its train-mode gradients, with the
    shared blocks and with the blocks' old code: equal bit for bit."""
    net = midas.seeded_init_(midas.MidasNet(features=32, backbone_layers=(1, 1, 1, 1)), 1)
    x = _images(n=2, seed=4)[:, :32, :64]

    def run():
        net.eval()
        with torch.no_grad():
            d = depth_model.depth_apply(net, x)
        net.train()
        net.zero_grad()
        depth_model.depth_apply(net, x).mean().backward()
        return [d] + [p.grad.clone() for p in net.parameters() if p.grad is not None]

    new = run()
    with monkeypatch.context() as m:
        _old_midas_blocks(m)
        old = run()
    assert len(new) == len(old) > 50
    assert all(torch.equal(a, b) for a, b in zip(new, old))


def test_the_cli_runs_dpt_large(tmp_path, monkeypatch):
    """python -m robust_cvd_tpu_torch --model_type dpt_large on a 6-frame
    64x96 clip (exact flows and masks on disk, so RAFT is loaded and not
    run), the CLI's DPT narrowed to the small widths: the registry's
    adapter takes the initial depth and the fine-tune's train steps, and
    the result tree carries the model's name."""
    from robust_cvd_tpu_torch.io.store import VideoStore
    from robust_cvd_tpu_torch.main import main

    n = 6
    base = cli_clip(tmp_path, monkeypatch, n)
    store = VideoStore.open(base)
    torch.save(_nets()[0].state_dict(),
               os.path.join(base, "models", dpt.DPTLargeAdapter.checkpoint))
    monkeypatch.setattr(dpt, "DPTDepthNet", functools.partial(dpt.DPTDepthNet, **SMALL))

    built = []
    orig = dpt.DPTLargeAdapter.from_checkpoint.__func__
    monkeypatch.setattr(dpt.DPTLargeAdapter, "from_checkpoint",
                        classmethod(lambda cls, p: built.append(p) or orig(cls, p)))
    proc = main(["--path", base, "--model_type", "dpt_large", "--size", str(W),
                 "--num_epochs", "1", "--save_tensorboard", "false",
                 "--opt.num_steps", "2", "--opt.ctf_long", "3", "--opt.ctf_short", "2",
                 "--opt.lm_max_outer", "4", "--opt.lm_cg_iters", "8"], device="cpu")
    assert built == [os.path.join(base, "models", dpt.DPTLargeAdapter.checkpoint)]
    assert isinstance(proc.tuner.adapter, dpt.DPTLargeAdapter)
    seen = []
    _record_precision(proc.tuner.net, seen)
    proc.tuner.infer_depth(batch=n)
    assert seen == ["high"]
    assert len(proc.tuner.history) == 1 and proc.tuner.history[0]["skipped"] == 0
    assert os.path.basename(proc.out_dir(n)).endswith("_dpt_large")
    depth0 = store.load_depth_stream("depth_dpt_large")
    assert depth0.shape == (n, H, W) and np.isfinite(depth0).all() and depth0.min() > 0


def cli_clip(tmp_path, monkeypatch, n, shift=2):
    """An n-frame H x W clip for the CLI: panning frames, their exact flows
    and masks on disk (so RAFT is loaded and not run) and a seeded small
    RAFT checkpoint under models/ (the CLI's RAFT narrowed to 2 iterations).
    Returns the clip's directory."""
    import chip_smoke
    from robust_cvd_tpu_torch.io import raw
    from robust_cvd_tpu_torch.io.frames import save_frames_txt
    from robust_cvd_tpu_torch.io.store import VideoStore, frame_name, save_png_color
    from robust_cvd_tpu_torch.models import raft
    from robust_cvd_tpu_torch.utils.frame_sampling import sample_pairs

    base = str(tmp_path / "clip")
    monkeypatch.setattr(chip_smoke, "H", H)
    monkeypatch.setattr(chip_smoke, "W", W)
    frames = chip_smoke.panning_frames(n, 0, shift)
    os.makedirs(os.path.join(base, "color_full"))
    os.makedirs(os.path.join(base, "color_down"))
    for i, f in enumerate(frames):
        save_png_color(os.path.join(base, "color_full", frame_name(i, ".png")), f)
        raw.save_raw_float32_image(os.path.join(base, "color_down", frame_name(i, ".raw")), f)
    save_frames_txt(os.path.join(base, "frames.txt"), W, H, [i / 30 for i in range(n)])
    store = VideoStore.open(base)
    entries, xs = [], np.arange(W, dtype=np.float32)
    for i, j in sample_pairs(n, ("hierarchical2",), two_way=True):
        flow = np.zeros((H, W, 2), np.float32)
        flow[..., 0] = (i - j) * shift
        mask = np.broadcast_to((np.floor(xs + (i - j) * shift + 0.5) >= 0)
                               & (np.floor(xs + (i - j) * shift + 0.5) < W), (H, W))
        store.save_flow(i, j, flow)
        store.save_flow_mask(i, j, mask)
        entries.append((i, j, float(mask.mean())))
    store.save_flow_list(entries)
    os.makedirs(os.path.join(base, "models"))
    monkeypatch.setattr(raft, "RAFT", functools.partial(raft.RAFT, iters=2,
                                                        dtype=torch.float32))
    torch.save(raft.seeded_init_(raft.RAFT(), 0).state_dict(),
               os.path.join(base, "models", "raft-things.pth"))
    return base
