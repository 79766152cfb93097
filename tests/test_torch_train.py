"""Training in videorenderer_tpu_torch against the JAX package on the CPU:
the trainers' losses and gradients, Adam and its schedule
(models/optim), ``train`` of both models, ``sgd_train_step``, the
augmentations and a trained float32 model's checkpoint, at the JAX tests'
tiny configs (SuperResConfig(channels=16, num_blocks=1, s2d=2),
VideoHDRConfig(channels=8)).  Both packages start from the same
parameters: JAX's, carried over with ``params_from_jax(..., float32)``.

Bands (the measured values are in PERF.md §6):
 * ``loss_fn``: <= 1e-6 relative (the forward is bit-equal; the means sum
   in different orders);
 * gradients: each weight within 1.6e-2 relative L2 of JAX's, cosine >=
   0.999; every leaf within the same band of the float32 gradient (the
   config's dtype float32, in JAX), and each bias leaf nearer to it than
   JAX's, whose bias gradients are bfloat16 sums (XLA on the CPU adds the
   bfloat16 cotangents in bfloat16; torch accumulates them in float32);
 * Adam on identical gradients: <= 2 float32 ulps of each parameter of
   the jitted optax step, 10 steps across both boundaries;
 * the schedule: equal to ``optax.piecewise_constant_schedule`` at every
   step;
 * ``train``, 10 steps: each loss within 1% relative, the final PSNR
   within 0.1 dB;
 * ``sgd_train_step``, 6 steps (tests/test_models.py's case): each loss
   within 1%, and the loss falls;
 * ``jpeg_roundtrip``, ``soften``: equal arrays.
The JAX quality gates of tests/test_sr_train.py and tests/test_hdr_train.py
hold for the port alone.
"""

import contextlib
import json
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from videorenderer_tpu.models import checkpoint as jck
from videorenderer_tpu.models import hdr_train as jhdr
from videorenderer_tpu.models import sr_train as jsr
from videorenderer_tpu.models import superres as jsres
from videorenderer_tpu.models import videohdr as jvh

from videorenderer_tpu_torch.models import checkpoint as tck
from videorenderer_tpu_torch.models import hdr_train as thdr
from videorenderer_tpu_torch.models import optim
from videorenderer_tpu_torch.models import sr_train as tsr
from videorenderer_tpu_torch.models import superres as tsres
from videorenderer_tpu_torch.models import videohdr as tvh

SR_TINY = dict(channels=16, num_blocks=1, s2d=2)
VH_TINY = dict(channels=8)
LOSS_REL = 1e-6
GRAD_REL, GRAD_COS = 1.6e-2, 0.999
ADAM_ULPS = 2
TRAJ_REL, PSNR_DB = 0.01, 0.1


def _f32(tree):
    return jax.tree_util.tree_map(lambda p: p.astype(jnp.float32), tree)


def _port_model(kind, jparams, **kw):
    """The port's model of ``kind`` holding JAX's parameters in float32."""
    model = (tsres.SuperRes(tsres.SuperResConfig(**kw)) if kind == "sr"
             else tvh.VideoHDR(tvh.VideoHDRConfig(**kw))).float()
    model.load_state_dict(tck.params_from_jax(jck._flatten(jparams),
                                              torch.float32))
    return model


def _case(kind, seed):
    """JAX float32 parameters (a nonzero last layer, biases not bfloat16
    values), the port's model of them, the JAX module of the loss, its
    config, and a batch (inputs, targets)."""
    rng = np.random.default_rng(seed)
    if kind == "sr":
        cfg = jsres.SuperResConfig(**SR_TINY)
        params = _f32(jsres.init_params(jax.random.PRNGKey(seed), cfg))
        hr = jsr.synth_frames(seed, 8, 32)
        batch = (jsr.degrade(hr), hr)
        last = "tail"
    else:
        cfg = jvh.VideoHDRConfig(**VH_TINY)
        params = _f32(jvh.init_params(jax.random.PRNGKey(seed), cfg))
        hdr = jhdr.synth_hdr_frames(seed, 8, 32, cfg)
        batch = (jhdr.degrade_to_sdr(hdr, cfg), jhdr.hdr_truth_pq(hdr, cfg))
        last = "c3"
    params[last]["w"] = jnp.asarray(rng.normal(
        0, 0.03, params[last]["w"].shape).astype(np.float32))
    for leaf in jck._flatten(params):
        if leaf.endswith("/b"):
            *path, _ = leaf.split("/")
            node = params
            for k in path:
                node = node[int(k) if k.isdigit() else k]
            node["b"] = jnp.asarray(rng.normal(0, 0.01, node["b"].shape)
                                    .astype(np.float32))
    model = _port_model(kind, params, **(SR_TINY if kind == "sr"
                                         else VH_TINY))
    jloss = jsres.loss_fn if kind == "sr" else jhdr.loss_fn
    tloss = tsres.loss_fn if kind == "sr" else thdr.loss_fn
    return params, model, jloss, tloss, cfg, batch


def loss_rel(kind, seed):
    """The port's loss (a tensor) and its relative distance to JAX's."""
    params, model, jloss, tloss, cfg, (x, y) = _case(kind, seed)
    want = float(jloss(params, jnp.asarray(x), jnp.asarray(y), cfg))
    got = tloss(model, torch.tensor(x), torch.tensor(y))
    return got, abs(float(got) - want) / want


@pytest.mark.parametrize("kind", ["sr", "vh"])
@pytest.mark.parametrize("seed", [0, 1])
def test_loss_fn_equals_jax(kind, seed):
    got, rel = loss_rel(kind, seed)
    assert got.dtype == torch.float32 and got.shape == ()
    assert rel <= LOSS_REL, rel


def _rel_cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (float(np.linalg.norm(a - b) / np.linalg.norm(b)),
            float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b))))


def grad_bands(kind):
    """For each leaf: (relative L2, cosine) of the port's gradient against
    JAX's and against the float32 gradient (the config's dtype float32, in
    JAX), and of JAX's against the float32 one."""
    params, model, jloss, tloss, cfg, (x, y) = _case(kind, 2)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    jgrads = jck._flatten(jax.grad(jloss)(params, jx, jy, cfg))
    ref = jck._flatten(jax.grad(jloss)(
        params, jx, jy, type(cfg)(**{**cfg.__dict__, "dtype": jnp.float32})))
    _, grads = optim.value_and_grad(tloss, model, torch.tensor(x),
                                    torch.tensor(y))
    assert not any(p.requires_grad for p in model.parameters())
    names = [n for n, _ in model.named_parameters()]
    got = tck.params_to_jax(dict(zip(names, grads)))
    assert set(got) == set(jgrads)
    return {key: {"port_vs_jax": _rel_cos(g, jgrads[key]),
                  "port_vs_f32": _rel_cos(g, ref[key]),
                  "jax_vs_f32": _rel_cos(jgrads[key], ref[key])}
            for key, g in got.items()}


@pytest.mark.parametrize("kind", ["sr", "vh"])
def test_gradients_against_jax(kind):
    for key, b in grad_bands(kind).items():
        rel, cos = b["port_vs_f32"]
        assert rel <= GRAD_REL and cos >= GRAD_COS, (key, b)
        if key.endswith("/w"):
            rel, cos = b["port_vs_jax"]
            assert rel <= GRAD_REL and cos >= GRAD_COS, (key, b)
        else:
            assert rel <= b["jax_vs_f32"][0], (key, b)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def adam_ulps(steps, make_opt=None):
    """Each step feeds the same gradients (JAX's of the tiny SuperRes at
    the current parameters, or random ones down to 1e-6) to the jitted
    optax step, as the JAX train runs it, and to the port's Adam (or
    ``make_opt(params, steps)``'s); returns each step's largest distance
    in float32 ulps over the parameters."""
    params, model, jloss, _, cfg, (x, y) = _case("sr", 3)
    rng = np.random.default_rng(4)
    tx = optax.adam(optax.piecewise_constant_schedule(
        1e-3, {int(steps * 0.6): 0.3, int(steps * 0.85): 0.3}))

    @jax.jit
    def step(p, st, g):
        u, st = tx.update(g, st, p)
        return optax.apply_updates(p, u), st

    jp, st = params, tx.init(params)
    tparams = dict(model.named_parameters())
    opt = (make_opt or (lambda ps, n: optim.Adam(
        ps, optim.lr_schedule(n, 1e-3, 0.3))))(list(tparams.values()), steps)
    worst = []
    for s in range(steps):
        g = jax.grad(jloss)(jp, jnp.asarray(x), jnp.asarray(y), cfg)
        if s % 2:
            g = jax.tree_util.tree_map(lambda a: jnp.asarray(
                (rng.normal(size=a.shape) * 10.0 ** rng.uniform(-6, 0))
                .astype(np.float32)), g)
        jp, st = step(jp, st, g)
        tg = tck.params_from_jax(jck._flatten(g), torch.float32)
        for name, p in tparams.items():
            p.grad = tg[name]
        opt.step()
        got = tck.params_to_jax({k: v.detach() for k, v in tparams.items()})
        want = jck._flatten(jp)
        worst.append(max(_ulps(got[k], want[k]) for k in want))
    if make_opt is None:
        assert opt.count == steps
    return worst


@pytest.mark.parametrize("steps", [2, 10])
def test_adam_equals_optax_on_identical_gradients(steps):
    worst = adam_ulps(steps)
    assert max(worst) <= ADAM_ULPS, worst


@pytest.mark.parametrize("steps", [1, 2, 3, 7, 10, 100])
def test_schedule_equals_optax(steps):
    want = optax.piecewise_constant_schedule(
        1e-3, {int(steps * 0.6): 0.3, int(steps * 0.85): 0.3})
    got = optim.lr_schedule(steps, 1e-3, 0.3)
    for t in range(steps + 2):
        assert got(t) == float(want(t)), (t, got(t), float(want(t)))
    # the two boundaries coincide below 3 steps: one decay, not two
    assert got(steps - 1) == (1e-3 * 0.3 if steps < 3 else
                              0.3 * (0.3 * 1e-3))
    with pytest.raises(ValueError):
        optim.piecewise_constant_schedule(1.0, {2: -0.5})


def trajectory(kind):
    """10 steps of ``train`` in both packages from JAX's start: (the
    port's losses, JAX's, the port's final PSNR pair, JAX's, the port's
    model, its start).  VideoHDR trains and scores on JAX's SDR inputs
    and truths in both packages."""
    steps, batch, lr = 10, 8, 2e-3
    if kind == "sr":
        cfg = jsres.SuperResConfig(**SR_TINY)
        data = jsr.synth_frames(5, 48, 32)
        val = jsr.synth_frames(999, 8, 32)
        jparams = jsres.init_params(jax.random.PRNGKey(0), cfg)
        jmodel, jl = jsr.train(cfg, steps, batch, data, seed=0,
                               learning_rate=lr)
        jdb = jsr.evaluate_psnr(jmodel, cfg, val)
        tcfg = tsres.SuperResConfig(**SR_TINY)
        tmod, teval, patches = tsr, tsr.evaluate_psnr, ()
    else:
        cfg = jvh.VideoHDRConfig(**VH_TINY)
        data = jhdr.synth_hdr_frames(5, 48, 32, cfg)
        val = jhdr.synth_hdr_frames(999, 8, 32, cfg)
        jparams = jvh.init_params(jax.random.PRNGKey(0), cfg)
        jmodel, jl = jhdr.train(cfg, steps, batch, data, seed=0,
                                learning_rate=lr)
        jdb = jhdr.evaluate_pq_psnr(jmodel, cfg, val)
        tcfg = tvh.VideoHDRConfig(**VH_TINY)
        tmod, teval = thdr, thdr.evaluate_pq_psnr
        patches = (mock.patch.object(thdr, "degrade_to_sdr", lambda h, c:
                                     jhdr.degrade_to_sdr(h, cfg)),
                   mock.patch.object(thdr, "hdr_truth_pq", lambda h, c:
                                     jhdr.hdr_truth_pq(h, cfg)))
    start = _port_model("sr" if kind == "sr" else "vh", jparams,
                        **(SR_TINY if kind == "sr" else VH_TINY))
    start.to(torch.bfloat16)
    with contextlib.ExitStack() as stack:
        for patch in patches:
            stack.enter_context(patch)
        model, tl = tmod.train(tcfg, steps, batch, data, seed=0,
                               learning_rate=lr, model=start, device="cpu")
        tdb = teval(model, val)
    return tl, jl, tdb, jdb, model, start


@pytest.mark.parametrize("kind", ["sr", "hdr"])
def test_train_trajectory_equals_jax(kind):
    tl, jl, tdb, jdb, model, start = trajectory(kind)
    assert len(tl) == 10 and all(isinstance(v, float) for v in tl)
    rel = np.abs(np.asarray(tl) - jl) / np.asarray(jl)
    assert rel.max() <= TRAJ_REL, rel
    assert abs(tdb[0] - jdb[0]) <= PSNR_DB and abs(tdb[1] - jdb[1]) \
        <= PSNR_DB, (tdb, jdb)
    # float32 master weights, never rounded to bfloat16 between steps; the
    # caller's model unchanged
    w = dict(model.named_parameters())
    assert all(p.dtype == torch.float32 and not p.requires_grad
               for p in w.values())
    assert any(not torch.equal(p, p.bfloat16().float()) for p in w.values())
    assert all(p.dtype == torch.bfloat16 for p in start.parameters())


def sgd_losses():
    """tests/test_models.py's case: 6 momentum-SGD steps of a bfloat16
    SuperRes (channels 8, one block, s2d 4) at learning rate 0.05 in both
    packages; (the port's losses, JAX's, the port's model)."""
    cfg = jsres.SuperResConfig(channels=8, num_blocks=1, scale=2)
    params = jsres.init_params(jax.random.PRNGKey(0), cfg)
    lr = np.random.default_rng(0).random((2, 8, 8, 3), np.float32)
    hr = np.random.default_rng(1).random((2, 16, 16, 3), np.float32)
    model = tsres.SuperRes(tsres.SuperResConfig(channels=8, num_blocks=1,
                                                scale=2))
    model.load_state_dict(tck.params_from_jax(jck._flatten(params)))
    jl, tl = [], []
    p, o = params, jsres.init_opt_state(params)
    to = tsres.init_opt_state(model)
    assert all(v.dtype == torch.float32 for v in to.values())
    for _ in range(6):
        p, o, loss = jsres.sgd_train_step(p, o, jnp.asarray(lr),
                                          jnp.asarray(hr), cfg,
                                          learning_rate=0.05)
        jl.append(float(loss))
        model, to, loss = tsres.sgd_train_step(
            model, to, torch.from_numpy(lr), torch.from_numpy(hr),
            learning_rate=0.05)
        tl.append(float(loss))
    return tl, jl, model


def test_sgd_train_step_equals_jax():
    tl, jl, model = sgd_losses()
    rel = np.abs(np.asarray(tl) - jl) / np.asarray(jl)
    assert rel.max() <= TRAJ_REL, (tl, jl)
    assert tl[-1] < tl[0]
    assert all(v.dtype == torch.bfloat16 and not v.requires_grad
               for v in model.parameters())


def test_superres_quality_gate():
    """tests/test_sr_train.py's gate with the port alone."""
    cfg = tsres.SuperResConfig(**SR_TINY)
    data = tsr.synth_frames(seed=5, n=48, size=32)
    val = tsr.synth_frames(seed=999, n=8, size=32)
    model, losses = tsr.train(cfg, steps=1000, batch=8, data_hr=data,
                              seed=0, learning_rate=2e-3, device="cpu")
    head, tail = np.mean(losses[:10]), np.mean(losses[-10:])
    assert tail < 0.7 * head, (head, tail)
    net_db, base_db = tsr.evaluate_psnr(model, val)
    un_db, _ = tsr.evaluate_psnr(
        tsres.init_params(torch.Generator().manual_seed(0), cfg), val)
    assert net_db > un_db + 1.0, (net_db, un_db, base_db)
    assert net_db > base_db, (net_db, base_db)


def test_videohdr_quality_gate():
    """tests/test_hdr_train.py's gate with the port alone."""
    cfg = tvh.VideoHDRConfig(**VH_TINY)
    data = thdr.synth_hdr_frames(seed=5, n=48, size=32, cfg=cfg)
    val = thdr.synth_hdr_frames(seed=999, n=8, size=32, cfg=cfg)
    model, losses = thdr.train(cfg, steps=400, batch=8, hdr_nits=data,
                               seed=0, learning_rate=2e-3, device="cpu")
    assert np.mean(losses[-10:]) < 0.7 * np.mean(losses[:10])
    net_db, base_db = thdr.evaluate_pq_psnr(model, val)
    assert net_db > base_db + 1.0, (net_db, base_db)


@pytest.mark.parametrize("name", ["jpeg_roundtrip", "soften"])
def test_augmentations_equal_jax(name):
    pytest.importorskip("PIL")
    frames = jsr.synth_frames(7, 4, 32)
    got = getattr(tsr, name)(frames, seed=3)
    assert got.dtype == np.float32
    assert np.array_equal(got, getattr(jsr, name)(frames, seed=3))
    assert not np.array_equal(got, frames)


def test_trained_checkpoint_loads_in_jax(tmp_path):
    """A trained float32 model's checkpoint holds its float32 values under
    the JAX keys: JAX's load_params reads them back exactly, and the JAX
    apply_fn of them equals the port's."""
    cfg = tsres.SuperResConfig(**SR_TINY)
    model, _ = tsr.train(cfg, 3, 4, tsr.synth_frames(1, 8, 32),
                         device="cpu")
    path = str(tmp_path / "sr.npz")
    tck.save_params(path, model)
    jcfg = jsres.SuperResConfig(**SR_TINY)
    jparams = jck.load_params(path, _f32(jsres.init_params(
        jax.random.PRNGKey(0), jcfg)))
    flat = jck._flatten(jparams)
    mine = tck.params_to_jax(model.state_dict())
    assert all(np.array_equal(flat[k], mine[k]) for k in mine)
    assert any(not np.array_equal(v, v.astype(jnp.bfloat16).astype(
        np.float32)) for v in mine.values())
    lr = jsr.degrade(jsr.synth_frames(2, 2, 32))
    assert np.array_equal(np.asarray(jsres.apply_fn(jparams, jnp.asarray(lr),
                                                    jcfg)),
                          tsres.apply_fn(model, torch.from_numpy(lr)).numpy())
    back = tck.load_params(path, tsres.SuperRes(cfg))
    for k, v in back.state_dict().items():
        assert torch.equal(v, model.state_dict()[k].bfloat16())


def test_train_runs_on_the_card_unless_told():
    cfg = tsres.SuperResConfig(**SR_TINY)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tsr.train(cfg, 1, 2, tsr.synth_frames(1, 2, 32))
        with pytest.raises(RuntimeError, match="CUDA"):
            thdr.train(tvh.VideoHDRConfig(**VH_TINY), 1, 2,
                       thdr.synth_hdr_frames(1, 2, 32))
    model, losses = tsr.train(cfg, 0, 2, tsr.synth_frames(1, 2, 32),
                              device="cpu")
    assert losses == [] and model.head.weight.dtype == torch.float32


class _TorchAdam:
    """``torch.optim.Adam(foreach=False)`` under the trainers' schedule, for
    :func:`report`'s comparison."""

    def __init__(self, params, steps):
        self.opt = torch.optim.Adam(params, lr=1e-3, foreach=False)
        self.schedule = optim.lr_schedule(steps, 1e-3, 0.3)
        self.count = 0

    def step(self):
        self.opt.param_groups[0]["lr"] = self.schedule(self.count)
        self.opt.step()
        self.count += 1


class _PartlyPlainAdam(torch.optim.Optimizer):
    """The port's Adam with one of its emulations of XLA's rounding left
    out (``plain``: "moments", their fused adds; "sqrt", the float64
    sqrt; "update", the update's fused add), or with all three, in
    optax's float32 order (``plain="all"``), for :func:`report`'s
    readings."""

    def __init__(self, params, steps, plain):
        super().__init__(params, {})
        self.schedule = optim.lr_schedule(steps, 1e-3, 0.3)
        self.count, self.plain = 0, plain

    @torch.no_grad()
    def step(self):
        lr = self.schedule(self.count)
        self.count += 1
        bc1, bc2 = (torch.full((), 1.0 - b ** self.count, dtype=torch.float32)
                    for b in (optim.B1, optim.B2))
        plain = self.plain
        for p in self.param_groups[0]["params"]:
            st = self.state[p]
            if not st:
                st["mu"], st["nu"] = torch.zeros_like(p), torch.zeros_like(p)
            g = p.grad.float()
            if plain in ("moments", "all"):
                mu = (1 - optim.B1) * g + optim.B1 * st["mu"]
                nu = (1 - optim.B2) * (g * g) + optim.B2 * st["nu"]
            else:
                mu = optim._fma(g, 1 - optim.B1, optim.B1 * st["mu"])
                nu = optim._fma(g * g, 1 - optim.B2, optim.B2 * st["nu"])
            st["mu"], st["nu"] = mu, nu
            if plain == "all":
                p.add_((mu / bc1) / (torch.sqrt(nu / bc2) + optim.EPS),
                       alpha=-lr)
                continue
            root = (torch.sqrt(nu / bc2) if plain == "sqrt"
                    else torch.sqrt((nu / bc2).double()).float())
            u = mu / (bc1 * (root + optim.EPS))
            if plain == "update":
                p.add_(u * np.float32(-lr))
            else:
                p.copy_(optim._fma(u, -lr, p))


def report() -> None:
    """Print the measured value of every band above as one JSON line (run
    from the repo root: ``JAX_PLATFORMS=cpu python -c 'import sys;
    sys.path[:0] = ["tests", "."]; import conftest, test_torch_train as t;
    t.report()'``)."""
    out = {"loss_rel": {f"{k}{s}": loss_rel(k, s)[1] for k in ("sr", "vh")
                        for s in (0, 1)},
           "grads": {k: grad_bands(k) for k in ("sr", "vh")},
           "adam_ulps": {n: adam_ulps(n) for n in (2, 10)},
           "torch_adam_ulps": {n: adam_ulps(n, _TorchAdam) for n in (2, 10)},
           "partly_plain_adam_ulps": {
               plain: {n: adam_ulps(n, lambda ps, k, plain=plain:
                                    _PartlyPlainAdam(ps, k, plain))
                       for n in (2, 10)}
               for plain in ("all", "moments", "sqrt", "update")}}
    for kind in ("sr", "hdr"):
        tl, jl, tdb, jdb, _, _ = trajectory(kind)
        out[f"train_{kind}"] = {
            "max_rel": float(np.max(np.abs(np.asarray(tl) - jl)
                                    / np.asarray(jl))),
            "psnr_diff_db": [tdb[0] - jdb[0], tdb[1] - jdb[1]]}
    tl, jl, _ = sgd_losses()
    out["sgd_max_rel"] = float(np.max(np.abs(np.asarray(tl) - jl)
                                      / np.asarray(jl)))
    print(json.dumps(out))
