"""The port's batched .raw IO engine (native/io_engine.cpp, a copy of the
JAX package's) and its depth-model registry, on the CPU.

The four cases of tests/test_native_io.py against the port: a batch read
equals the Python loop; a batch write is byte-identical to the JAX
package's native.write_raw_batch files and to raw.save_raw_float32_image;
a truncated file raises IOError; VideoStore loads color_down and depth
streams, and writes depth streams, through the engine, byte for byte the
JAX package's files. Beside them: a failed build of the engine raises, and
registry.get_depth_model("midas2") is the port's MidasV2Adapter (beside
the port's own `dpt_large`, `dpt_beit_large_512` and `dpt_swin2_large_384`),
whose
estimate_depth matches the JAX adapter's on the small MiDaS of
tests/test_torch_pkg_midas.py (1e-3 relative where the disparity is not
clipped, as there).
"""

import os
from os.path import join as pjoin

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_cvd_tpu import native as jnative
from robust_cvd_tpu.io import raw as jraw
from robust_cvd_tpu.io.store import VideoStore as JStore
from robust_cvd_tpu.models import midas as jm
from robust_cvd_tpu_torch import native
from robust_cvd_tpu_torch.io import raw
from robust_cvd_tpu_torch.io.frames import save_frames_txt
from robust_cvd_tpu_torch.io.store import VideoStore, frame_name
from robust_cvd_tpu_torch.models import midas as tm
from robust_cvd_tpu_torch.models import registry
from test_torch_pkg_midas import small_nets  # noqa: F401  (fixture)
from torch_pkg_threads import one_torch_thread  # noqa: F401  (autouse)


def test_read_raw_batch_matches_python(tmp_path):
    imgs = np.random.default_rng(0).standard_normal((5, 12, 17, 3)).astype(np.float32)
    paths = [str(tmp_path / f"frame_{i:06d}.raw") for i in range(5)]
    for p, img in zip(paths, imgs):
        raw.save_raw_float32_image(p, img)
    got = native.read_raw_batch(paths, 12, 17, 3, np.float32)
    np.testing.assert_array_equal(got, np.stack([raw.load_raw_float32_image(p) for p in paths]))
    np.testing.assert_array_equal(got, imgs)
    assert native.read_raw_header(paths[0]) == (12, 17, raw.cv_type(np.float32, 3))


@pytest.mark.parametrize("shape", [(4, 9, 7), (3, 5, 6, 3)])
def test_write_raw_batch_is_byte_identical(tmp_path, shape):
    imgs = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    for name, write in (
        ("t", lambda ps: native.write_raw_batch(ps, imgs)),
        ("j", lambda ps: jnative.write_raw_batch(ps, imgs)),
        ("r", lambda ps: [raw.save_raw_float32_image(p, x) for p, x in zip(ps, imgs)]),
    ):
        os.makedirs(tmp_path / name)
        write([str(tmp_path / name / f"d_{i}.raw") for i in range(shape[0])])
    for i in range(shape[0]):
        want = (tmp_path / "r" / f"d_{i}.raw").read_bytes()
        assert (tmp_path / "t" / f"d_{i}.raw").read_bytes() == want
        assert (tmp_path / "j" / f"d_{i}.raw").read_bytes() == want


def test_read_raw_batch_detects_corruption(tmp_path):
    paths = [str(tmp_path / f"x_{i}.raw") for i in range(3)]
    for p in paths:
        raw.save_raw_float32_image(p, np.zeros((4, 4), np.float32))
    with open(paths[1], "r+b") as f:  # truncated
        f.truncate(24)
    assert native.read_raw_batch(paths[:1], 4, 4, 1).shape == (1, 4, 4)
    with pytest.raises(IOError, match="x_1.raw"):
        native.read_raw_batch(paths, 4, 4, 1)
    with pytest.raises(IOError, match="x_0.raw"):  # the header disagrees
        native.read_raw_batch(paths[:1], 4, 5, 1)
    with pytest.raises(IOError):
        native.read_raw_batch(paths[:1] + [str(tmp_path / "absent.raw")], 4, 4, 1)
    with pytest.raises(IOError):
        native.write_raw_batch([str(tmp_path / "no_dir" / "a.raw")],
                               np.zeros((1, 2, 2), np.float32))
    with pytest.raises(IOError):
        native.read_raw_header(paths[1][:-4] + "_absent.raw")


def test_store_loads_and_writes_through_the_engine(tmp_path, monkeypatch):
    base, jbase = str(tmp_path / "t"), str(tmp_path / "j")
    h, w = 10, 14
    rng = np.random.default_rng(2)
    color = rng.uniform(0, 1, (3, h, w, 3)).astype(np.float32)
    for b in (base, jbase):
        os.makedirs(pjoin(b, "color_down"))
        save_frames_txt(pjoin(b, "frames.txt"), w, h, [0.0, 1 / 30, 2 / 30])
        for i in range(3):
            raw.save_raw_float32_image(pjoin(b, "color_down", frame_name(i, ".raw")), color[i])
    calls = []
    for name in ("read_raw_batch", "write_raw_batch"):
        fn = getattr(native, name)
        monkeypatch.setattr(native, name,
                            lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k))
    store = VideoStore.open(base)
    np.testing.assert_array_equal(store.load_color_down(), color)

    depth = rng.uniform(1, 5, (3, h, w)).astype(np.float32)
    depth[0, 0, 0] = np.inf  # an invalid depth is written as disparity 0
    store.save_depth_stream("depth_test", depth)
    JStore.open(jbase).save_depth_stream("depth_test", depth)
    for i in range(3):
        name = pjoin("depth_test", "depth", frame_name(i, ".raw"))
        assert open(pjoin(base, name), "rb").read() == open(pjoin(jbase, name), "rb").read()
    back = VideoStore.open(base).load_depth_stream("depth_test")
    np.testing.assert_array_equal(back, JStore.open(jbase).load_depth_stream("depth_test"))
    np.testing.assert_allclose(back[depth > 0][1:], depth[np.isfinite(depth)], rtol=1e-6)
    assert back[0, 0, 0] == 0
    assert calls == ["read_raw_batch", "write_raw_batch", "read_raw_batch"]
    # a frame of another shape in the stream raises
    jraw.save_raw_float32_image(pjoin(base, "depth_test", "depth", frame_name(2, ".raw")),
                                np.ones((h, w + 1), np.float32))
    with pytest.raises(IOError):
        VideoStore.open(base).load_depth_stream("depth_test")


def test_io_engine_build_failure_raises(monkeypatch, tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_IO_SRC", str(bad))
    monkeypatch.setattr(native, "_IO_SO", str(tmp_path / "bad.so"))
    monkeypatch.setattr(native, "_io_lib", None)
    with pytest.raises(RuntimeError, match="failed"):
        native.read_raw_batch([str(tmp_path / "a.raw")], 2, 2, 1)


def test_registry_gives_the_port_adapter(small_nets):  # noqa: F811
    assert registry.get_depth_model("midas2") is tm.MidasV2Adapter
    # the port registers DPT-Large (models/dpt.py) beside the reference's midas2
    assert registry.get_depth_model_list() == ["dpt_beit_large_512", "dpt_large",
                                               "dpt_swin2_large_384", "midas2"]
    with pytest.raises(KeyError, match="midas2"):
        registry.get_depth_model("dpt")

    @registry.register("custom")
    class Custom:
        pass

    try:
        assert registry.get_depth_model("custom") is Custom
        assert registry.get_depth_model_list() == ["custom", "dpt_beit_large_512", "dpt_large",
                                                    "dpt_swin2_large_384", "midas2"]
    finally:
        registry._REGISTRY.pop("custom")

    fnet, variables, tnet = small_nets
    jad = jm.MidasV2Adapter(params=variables["params"], batch_stats=variables["batch_stats"])
    jad.net = fnet
    tad = registry.get_depth_model("midas2")(tnet.train())
    x = np.random.default_rng(3).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    scales = np.random.default_rng(4).uniform(0.5, 2.0, (2, 1, 1)).astype(np.float32)
    disp = np.asarray(fnet.apply(variables, jm.normalize_images(jnp.asarray(x))))
    live = disp > 1e-3  # depth = 1/(disparity + 1e-7) explodes where clipped
    assert live.mean() > 0.2
    for s in (None, scales):
        want = np.asarray(jad.estimate_depth(jnp.asarray(x), None if s is None else jnp.asarray(s)))
        got = tad.estimate_depth(torch.from_numpy(x), None if s is None else torch.from_numpy(s))
        assert got.shape == (2, 64, 64) and not got.requires_grad
        np.testing.assert_allclose(got.numpy()[live], want[live], rtol=1e-3)
    assert tnet.training  # the adapter gives the net back in its mode
