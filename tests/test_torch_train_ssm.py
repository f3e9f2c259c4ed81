"""Training of the Mamba families in the port against ``repro.models.lm``:
the loss and every leaf's gradient on the smoke configs of falcon-mamba-7b
(Mamba1) and zamba2-1.2b (Mamba2 + the shared block; also a 5-layer variant
with G = 2 groups, where the shared block's gradient sums over both),
with the reference's own fp32 weights (PRNGKey(0)) carried over by
``from_reference(cast=False)``, and the train step.

The JAX oracle is ``jax.value_and_grad(repro.models.lm.loss_fn)``, jitted
once per (config, S). The port runs with ``remat`` on (a checkpoint per
layer, and per whole group in the hybrid) and off. S = 16 is a multiple of
the smoke config's ``ssm_chunk`` (8); S = 13 is not (the reference's scans
then run one chunk).

On the CPU the port's Mamba1 scan is the plain sequential scan under
autograd (the backward kernel's plain version). The kernel's own order of
work (states saved every 32 steps, each chunk recomputed from its saved
state, then walked backwards) is rendered in plain torch here and held to
autograd through ``mamba_scan_ref``.

Tolerances, with a margin over what these inputs give:

* fp32 compute: loss terms within 1e-5 relative; every gradient leaf
  within 1e-4 of that leaf's largest magnitude;
* bf16 compute: loss terms within 2e-3 relative (as
  ``tests/test_torch_train_step.py``);
* the kernel-order rendering against autograd (fp32, float64 for the
  oracle): every gradient within 1e-5 of its largest magnitude;
* one train step (AdamW, fp32): as ``tests/test_torch_train_step.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.sharding import ShardCtx
from repro.models import lm as jlm
from repro.optim.adamw import OptConfig as JOptConfig
from repro.optim.adamw import init_opt_state as j_init_opt
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch.kernels import ops
from repro_torch.kernels.ref import mamba_scan_ref
from repro_torch.models import lm as tlm
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.params import from_reference
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import leaves
from test_torch_parity import smoke_cfg, to_np

LOSS_REL = {"float32": 1e-5, "bfloat16": 2e-3}
GRAD_REL = 1e-4
ORDER_REL = 1e-5
STEP_REL = 1e-5
PARAM_STEP_LR = 5e-2
LOSS_KEYS = ("ce", "zloss", "aux")
B = 2
# (arch, layers): the smoke depth, and zamba2 at 5 layers (G = 2, tail 1)
CONFIGS = [("falcon-mamba-7b", None), ("zamba2-1.2b", None),
           ("zamba2-1.2b", 5)]
IDS = ["falcon-mamba", "zamba2", "zamba2-G2"]


def _cfg(arch, dt, layers=None, remat=True):
    cfg = dataclasses.replace(smoke_cfg(arch, dt), remat=remat)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          num_layers=layers)


@functools.lru_cache(maxsize=None)
def _ref_tree(arch, layers):
    jp = jax.jit(jlm.init_params, static_argnums=(0,))(
        _cfg(arch, "float32", layers), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, jp)


def _tokens(cfg, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _oracle(arch, layers, dt, S):
    """The reference's loss, metrics and (fp32) gradients as numpy."""
    cfg = _cfg(arch, dt, layers)
    jp = jax.tree_util.tree_map(jnp.asarray, _ref_tree(arch, layers))
    batch = {"tokens": jnp.asarray(_tokens(cfg, S))}
    if dt == "float32":
        fn = jax.value_and_grad(lambda p: jlm.loss_fn(cfg, p, batch),
                                has_aux=True)
        (tot, met), g = jax.jit(fn)(jp)
        paths = [jax.tree_util.keystr(p) for p, _ in
                 jax.tree_util.tree_leaves_with_path(g)]
        grads = list(zip(paths, map(np.asarray,
                                    jax.tree_util.tree_leaves(g))))
    else:
        tot, met = jax.jit(lambda p: jlm.loss_fn(cfg, p, batch))(jp)
        grads = None
    return float(tot), {k: float(v) for k, v in met.items()}, grads


def _rel_close(a, b, rel, what):
    a, b = to_np(a), np.asarray(b, np.float32)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = float(np.max(np.abs(b))) if b.size else 0.0
    err = float(np.max(np.abs(a - b))) if a.size else 0.0
    assert err <= rel * max(scale, 1e-30), \
        f"{what}: max abs err {err} > {rel} x {scale}"


@pytest.mark.parametrize("S", [16, 13])
@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch,layers", CONFIGS, ids=IDS)
def test_loss_and_grads_match_reference(arch, layers, remat, S):
    jtot, jmet, jgrads = _oracle(arch, layers, "float32", S)
    cfg = _cfg(arch, "float32", layers, remat)
    tp = from_reference(_ref_tree(arch, layers), cfg, device="cpu",
                        cast=False)
    flat = [t.requires_grad_(True) for t in leaves(tp)]
    ttot, tmet = tlm.loss_fn(cfg, tp, {"tokens": torch.from_numpy(
        _tokens(cfg, S))})
    _rel_close(ttot, jtot, LOSS_REL["float32"], "total loss")
    for k in LOSS_KEYS:
        _rel_close(tmet[k], jmet[k], LOSS_REL["float32"], k)
    assert float(tmet["aux"]) == 0.0
    tg = torch.autograd.grad(ttot, flat)
    assert len(tg) == len(jgrads)
    for (name, g_j), g_t in zip(jgrads, tg):
        _rel_close(g_t, g_j, GRAD_REL, f"grad {name}")


@pytest.mark.parametrize("arch,layers", CONFIGS[:2], ids=IDS[:2])
def test_bf16_loss_matches_reference(arch, layers):
    jtot, jmet, _ = _oracle(arch, layers, "bfloat16", 16)
    cfg = _cfg(arch, "bfloat16", layers)
    tp = from_reference(_ref_tree(arch, layers), cfg, device="cpu",
                        cast=False)
    flat = [t.requires_grad_(True) for t in leaves(tp)]
    ttot, tmet = tlm.loss_fn(cfg, tp, {"tokens": torch.from_numpy(
        _tokens(cfg, 16))})
    _rel_close(ttot, jtot, LOSS_REL["bfloat16"], "total loss")
    for k in ("ce", "zloss"):
        _rel_close(tmet[k], jmet[k], LOSS_REL["bfloat16"], k)
    # the gradients reach every fp32 master leaf, finite
    for t, g in zip(flat, torch.autograd.grad(ttot, flat)):
        assert g.dtype == t.dtype == torch.float32
        assert torch.isfinite(g).all()


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b"])
def test_train_step_matches_reference(arch):
    """Two microbatches: the SSM archs' gradients accumulate as the
    attention archs' do."""
    cfg = _cfg(arch, "float32")
    tree = _ref_tree(arch, None)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = from_reference(tree, cfg, device="cpu", cast=False)
    toks = _tokens(cfg, 16, seed=1)
    jopt = JOptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    opt = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    fn, _, _ = j_make_train_step(cfg, ShardCtx(mesh=None), jopt,
                                 microbatches=2)
    jp2, jst2, jm = jax.jit(fn)(jp, j_init_opt(jp, jopt),
                                {"tokens": jnp.asarray(toks)})
    tp2, tst2, tm = make_train_step(cfg, opt, microbatches=2)(
        tp, init_opt_state(tp, opt), {"tokens": torch.from_numpy(toks)})
    assert set(tm) == set(jm)
    for k in jm:
        _rel_close(tm[k], jm[k], STEP_REL, f"metric {k}")
    for what, t, j in (("params", tp2, jp2), ("m", tst2["m"], jst2["m"]),
                       ("v", tst2["v"], jst2["v"])):
        for a, b in zip(leaves(t), jax.tree_util.tree_leaves(j)):
            if what == "params":
                err = float(np.max(np.abs(to_np(a) - to_np(b))))
                assert err <= PARAM_STEP_LR * opt.lr, err
            else:
                _rel_close(a, b, STEP_REL, what)


# ----------------------------------------------- the backward's order of work
def _scan_inputs(Bb, S, dI, N, seed, h0=False):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))
    dt = torch.nn.functional.softplus(t(Bb, S, dI)) * 0.1
    out = [dt, t(Bb, S, dI), t(Bb, S, N), t(Bb, S, N),
           -torch.exp(t(dI, N, scale=0.5))]
    return out + [t(Bb, dI, N) if h0 else None]


def _bwd_in_kernel_order(dt, x, Bc, Cc, A, h0, dy, dhT, chunk=32):
    """The backward kernel's work in plain torch: the forward keeps the
    state before every ``chunk`` steps; the backward walks the chunks in
    reverse, recomputes a chunk's states from its saved one, then runs
    g_t = C_t dy_t + a_{t+1} g_{t+1} backwards through it."""
    Bb, S, dI = x.shape
    N = A.shape[1]
    h = torch.zeros((Bb, dI, N)) if h0 is None else h0.clone()
    saved = []
    for t in range(S):
        if t % chunk == 0:
            saved.append(h)
        h = torch.exp(dt[:, t, :, None] * A) * h \
            + (dt[:, t] * x[:, t])[..., None] * Bc[:, t, None, :]
    g = torch.zeros((Bb, dI, N)) if dhT is None else dhT.clone()
    ddt, dx = torch.zeros_like(dt), torch.zeros_like(x)
    dB, dC, dA = torch.zeros_like(Bc), torch.zeros_like(Cc), \
        torch.zeros_like(A)
    for c in reversed(range(len(saved))):
        t0 = c * chunk
        hs = [saved[c]]
        for t in range(t0, min(S, t0 + chunk)):
            hs.append(torch.exp(dt[:, t, :, None] * A) * hs[-1]
                      + (dt[:, t] * x[:, t])[..., None] * Bc[:, t, None, :])
        for u in reversed(range(len(hs) - 1)):
            t = t0 + u
            a = torch.exp(dt[:, t, :, None] * A)
            g = g + Cc[:, t, None, :] * dy[:, t, :, None]
            w = g * hs[u] * a
            s1 = (g * Bc[:, t, None, :]).sum(-1)
            ddt[:, t] = x[:, t] * s1 + (w * A).sum(-1)
            dx[:, t] = dt[:, t] * s1
            dB[:, t] = (g * (dt[:, t] * x[:, t])[..., None]).sum(1)
            dC[:, t] = (hs[u + 1] * dy[:, t, :, None]).sum(1)
            dA += (w * dt[:, t, :, None]).sum(0)
            g = g * a
    return ddt, dx, dB, dC, dA


@pytest.mark.parametrize("final_grad", [False, True])
@pytest.mark.parametrize("S,h0", [(45, False), (64, False), (40, True)])
def test_backward_order_of_work_matches_autograd(S, h0, final_grad):
    """Ragged and whole chunks, a given initial state, a gradient on the
    final state or none."""
    dt, x, Bc, Cc, A, init = _scan_inputs(2, S, 12, 16, seed=S, h0=h0)
    rng = np.random.default_rng(7)
    dy = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    dhT = torch.from_numpy(rng.standard_normal((2, 12, 16)).astype(
        np.float32)) if final_grad else None
    ins = [t.double().requires_grad_(True) for t in (dt, x, Bc, Cc, A)]
    y, hT = mamba_scan_ref(ins[0], ins[4], ins[2], ins[3], ins[1],
                           h0=None if init is None else init.double())
    outs, gouts = [y], [dy.double()]
    if dhT is not None:
        outs.append(hT)
        gouts.append(dhT.double())
    want = torch.autograd.grad(outs, ins, gouts)
    got = _bwd_in_kernel_order(dt, x, Bc, Cc, A, init, dy, dhT)
    for name, a, b in zip(("dt", "x", "B", "C", "A"), got, want):
        _rel_close(a, b.float(), ORDER_REL, f"d{name}")


def test_mamba_scan_on_the_cpu_is_autograd_through_the_plain_scan():
    dt, x, Bc, Cc, A, _ = _scan_inputs(2, 21, 8, 16, seed=3)
    ins = [t.requires_grad_(True) for t in (dt, x, Bc, Cc, A)]
    before = ops.launch_counts()
    y, hT = ops.mamba_scan(*ins)
    yr, hr = mamba_scan_ref(ins[0], ins[4], ins[2], ins[3], ins[1])
    assert torch.equal(y, yr) and torch.equal(hT, hr)
    assert y.requires_grad
    g = torch.autograd.grad(y.sum(), ins)
    gr = torch.autograd.grad(yr.sum(), ins)
    assert all(torch.equal(a, b) for a, b in zip(g, gr))
    assert ops.launch_counts() == before       # no kernel on the CPU
    with pytest.raises(ValueError, match="h0 takes no gradient"):
        ops.mamba_scan(dt, x, Bc, Cc, A,
                       h0=torch.zeros((2, 8, 16), requires_grad=True))


@pytest.mark.parametrize("max_elems", [1, 2 * 8 * 8 * 3 * 2])
def test_ssd_in_chunk_groups_matches_reference(max_elems, monkeypatch):
    """The SSD's intra-chunk products in groups of chunks (one chunk a
    group, and two: 5 chunks leave a short last group) against the
    reference's ``_ssd_scan`` and its gradient (``jax.value_and_grad``),
    fp32, within 1e-5 of each output's and gradient's largest
    magnitude."""
    from repro.models.mamba import _ssd_scan as j_ssd
    from repro_torch.models import mamba as tmamba
    monkeypatch.setattr(tmamba, "SSD_GROUP_ELEMS", max_elems)
    rng = np.random.default_rng(4)
    Bb, S, nh, hp, N, chunk = 2, 40, 3, 4, 5, 8
    arrs = dict(xh=rng.standard_normal((Bb, S, nh, hp)),
                dt=np.log1p(np.exp(rng.standard_normal((Bb, S, nh)))) * 0.1,
                A=-np.exp(rng.standard_normal(nh) * 0.5),
                Bc=rng.standard_normal((Bb, S, N)),
                Cc=rng.standard_normal((Bb, S, N)),
                h0=rng.standard_normal((Bb, nh, hp, N)))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    w = rng.standard_normal((Bb, S, nh, hp)).astype(np.float32)
    t = {k: torch.from_numpy(v).requires_grad_(k != "h0")
         for k, v in arrs.items()}
    y, hT = tmamba._ssd_scan(*t.values(), chunk)
    names = [k for k in t if k != "h0"]
    got = torch.autograd.grad((y * torch.from_numpy(w)).sum() + hT.sum(),
                              [t[k] for k in names])

    def jloss(xh, dt, A, Bc, Cc):
        yj, hj = j_ssd(xh, dt, A, Bc, Cc, jnp.asarray(arrs["h0"]), chunk)
        return jnp.sum(yj * w) + jnp.sum(hj), (yj, hj)
    (_, (yj, hj)), gj = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True))(
            *(jnp.asarray(arrs[k]) for k in names))
    _rel_close(y, np.asarray(yj), 1e-5, "y")
    _rel_close(hT, np.asarray(hj), 1e-5, "final state")
    for name, a, b in zip(names, got, gj):
        _rel_close(a, np.asarray(b), 1e-5, f"d{name}")



def test_ssd_gradient_stays_finite_where_a_chunk_overflows():
    """A chunk whose |sum dt A| passes ~88 overflows exp above the causal
    diagonal. The reference's ``where(mask, exp(seg), 0)`` then has a NaN
    gradient (0 * inf); the port masks before the exp: the same outputs,
    and the gradient of the per-step recurrence the dual form stands for
    (the port's fp32 dual form against the recurrence in float64, within
    1e-5 of each gradient's largest magnitude)."""
    from repro.models.mamba import _ssd_scan as j_ssd
    from repro_torch.models.mamba import _ssd_scan
    rng = np.random.default_rng(0)
    Bb, S, nh, hp, N = 1, 24, 2, 3, 4
    arrs = dict(xh=rng.standard_normal((Bb, S, nh, hp)),
                dt=np.full((Bb, S, nh), 2.0), A=-np.array([3.0, 0.5]),
                Bc=rng.standard_normal((Bb, S, N)),
                Cc=rng.standard_normal((Bb, S, N)))
    w = rng.standard_normal((Bb, S, nh, hp))

    def leaves_of(dtype):
        return {k: torch.from_numpy(v).to(dtype).requires_grad_(True)
                for k, v in arrs.items()}
    t = leaves_of(torch.float32)
    y, _ = _ssd_scan(t["xh"], t["dt"], t["A"], t["Bc"], t["Cc"],
                     torch.zeros((Bb, nh, hp, N)), S)
    got = torch.autograd.grad((y * torch.from_numpy(w).float()).sum(),
                              list(t.values()))
    t = leaves_of(torch.float64)
    h, ys = torch.zeros((Bb, nh, hp, N), dtype=torch.float64), []
    for s in range(S):
        a = torch.exp(t["dt"][:, s] * t["A"])[..., None, None]
        h = a * h + (t["dt"][:, s, :, None] * t["xh"][:, s])[..., None] \
            * t["Bc"][:, s, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", h, t["Cc"][:, s]))
    yr = torch.stack(ys, dim=1)
    want = torch.autograd.grad((yr * torch.from_numpy(w)).sum(),
                               list(t.values()))
    _rel_close(y, yr.detach().numpy(), 1e-5, "y")
    for name, a, b in zip(t, got, want):
        assert torch.isfinite(a).all(), name
        _rel_close(a, b.numpy(), 1e-5, f"d{name}")
    # the reference's forward agrees; its gradient is NaN here
    ja = {k: jnp.asarray(v, jnp.float32) for k, v in arrs.items()}

    def jloss(dt):
        yj, _ = j_ssd(ja["xh"], dt, ja["A"], ja["Bc"], ja["Cc"],
                      jnp.zeros((Bb, nh, hp, N), jnp.float32), S)
        return jnp.sum(yj * w), yj
    (_, yj), gj = jax.value_and_grad(jloss, has_aux=True)(ja["dt"])
    _rel_close(y, np.asarray(yj), 1e-5, "reference y")
    assert np.isnan(np.asarray(gj)).any()
