"""The Adam update of the PyTorch port (ops/adam.py, training/optimizer.py).

- With bias correction, `adam_update_plain` matches one optax.adam(lr)
  update plus optax.apply_updates on the same flat gradient, at step counts
  0 and 7, within 1e-6 relative on mu, nu and the update.
- Without it, it matches the formula of the Pallas kernel
  tools/probe_adam_bw.py::adam_kernel, restated here (that script runs a
  104M-element benchmark when imported), within 1e-6 relative.
- With the guard flag false nothing changes, bitwise, and FlatAdam's step
  count does not advance.
- On a CPU buffer `adam_update` takes the plain version and counts no
  launch; the kernel itself runs only on a card (a `cuda` test, skipped
  here; chip_smoke.py runs it at the full-width parameter count).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from robust_cvd_tpu_torch.ops import adam
from robust_cvd_tpu_torch.training.optimizer import FlatAdam

N = 1003  # not a multiple of 4: the kernel's scalar tail
LR = 1e-3


def _state(seed=0, n=N):
    rng = np.random.default_rng(seed)
    p = rng.normal(0, 1, n).astype(np.float32)
    g = rng.normal(0, 1e-2, n).astype(np.float32)
    mu = rng.normal(0, 1e-2, n).astype(np.float32)
    nu = rng.uniform(0, 1e-3, n).astype(np.float32)
    return p, g, mu, nu


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("count", [0, 7])
def test_plain_matches_optax_adam(count):
    p, g, mu, nu = _state(count)
    opt = optax.adam(LR)
    state = opt.init(jnp.asarray(p))
    state = (state[0]._replace(count=jnp.asarray(count, jnp.int32), mu=jnp.asarray(mu),
                               nu=jnp.asarray(nu)),) + tuple(state[1:])
    updates, new_state = opt.update(jnp.asarray(g), state, jnp.asarray(p))
    want_p = np.asarray(optax.apply_updates(jnp.asarray(p), updates))

    tp, tg, tmu, tnu = (torch.from_numpy(a.copy()) for a in (p, g, mu, nu))
    adam.adam_update_plain(tp, tg, tmu, tnu, torch.tensor(count, dtype=torch.int32),
                           torch.tensor(True), LR)
    assert _rel(tmu.numpy(), np.asarray(new_state[0].mu)) <= 1e-6
    assert _rel(tnu.numpy(), np.asarray(new_state[0].nu)) <= 1e-6
    assert _rel(tp.numpy() - p, want_p - p) <= 1e-6


def test_plain_without_bias_correction_is_adam_pl():
    p, g, mu, nu = _state(3)
    b1, b2, eps = 0.9, 0.999, 1e-8
    # tools/probe_adam_bw.py:105-111, adam_kernel
    want_mu = b1 * mu + (1 - b1) * g
    want_nu = b2 * nu + (1 - b2) * g * g
    want_p = p - LR * (want_mu / (np.sqrt(want_nu) + eps))
    tp, tg, tmu, tnu = (torch.from_numpy(a.copy()) for a in (p, g, mu, nu))
    adam.adam_update_plain(tp, tg, tmu, tnu, torch.tensor(5, dtype=torch.int32),
                           torch.tensor(True), LR, b1, b2, eps, bias_correction=False)
    assert _rel(tmu.numpy(), want_mu) <= 1e-6
    assert _rel(tnu.numpy(), want_nu) <= 1e-6
    assert _rel(tp.numpy() - p, want_p - p) <= 1e-6


@pytest.mark.parametrize("bias_correction", [True, False])
def test_guard_leaves_everything_unchanged(bias_correction):
    bufs = [torch.from_numpy(a) for a in _state(4)]
    bufs[1][7] = float("nan")
    before = [b.clone() for b in bufs]
    count = torch.tensor(3, dtype=torch.int32)
    launches = adam.adam_update.launches
    adam.adam_update(*bufs, count, torch.tensor(False), LR, bias_correction=bias_correction)
    assert adam.adam_update.launches == launches  # CPU: the plain version
    for a, b in zip(bufs, before):
        assert torch.equal(a, b) or torch.equal(a.isnan(), b.isnan())
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    assert int(count) == 3


def test_flat_adam_skips_non_finite_steps():
    lin = torch.nn.Linear(3, 2)
    opt = FlatAdam(list(lin.named_parameters()), LR)
    x = torch.randn(4, 3)
    opt.zero_grad()
    lin(x).sum().backward()
    opt.check_aliasing()
    assert bool(opt.step(torch.tensor(1.0))) and int(opt.count) == 1
    snap = [t.clone() for t in (opt.flat, opt.mu, opt.nu)]
    opt.zero_grad()
    (lin(x).sum() * float("inf")).backward()
    assert not bool(opt.step(torch.tensor(float("inf"))))
    assert int(opt.count) == 1
    for a, b in zip((opt.flat, opt.mu, opt.nu), snap):
        assert torch.equal(a, b)
    lin.weight.grad = None  # a replaced gradient no longer aliases the buffer
    with pytest.raises(RuntimeError, match="alias"):
        opt.check_aliasing()


def test_adam_update_checks_its_buffers():
    p, g, mu, nu = (torch.from_numpy(a) for a in _state(5))
    ok, count = torch.tensor(True), torch.tensor(0, dtype=torch.int32)
    with pytest.raises(ValueError):
        adam.adam_update(p, g[:-1], mu, nu, count, ok, LR)
    with pytest.raises(ValueError):
        adam.adam_update(p, g, mu, nu, count.long(), ok, LR)
    with pytest.raises(ValueError):
        adam.adam_update(p.half(), g.half(), mu.half(), nu.half(), count, ok, LR)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [N, 1_000_003])
@pytest.mark.parametrize("bias_correction", [True, False])
def test_kernel_matches_plain_on_card(n, bias_correction):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    base = [torch.from_numpy(a).cuda() for a in _state(6, n)]
    count = torch.tensor(7, dtype=torch.int32, device="cuda")
    ok = torch.tensor(True, device="cuda")
    got = [b.clone() for b in base]
    ref = [b.clone() for b in base]
    launches = adam.adam_update.launches
    adam.adam_update(*got, count, ok, LR, bias_correction=bias_correction)
    torch.cuda.synchronize()
    assert adam.adam_update.launches == launches + 1
    adam.adam_update_plain(*ref, count, ok, LR, bias_correction=bias_correction)
    for a, b in ((got[0] - base[0], ref[0] - base[0]), (got[2], ref[2]), (got[3], ref[3])):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item() + 1e-7
