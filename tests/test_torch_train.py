"""The port's training substrate (``repro_torch/train/{optimizer,
train_loop,compression}.py``, ``repro_torch/data/pipeline.py``) against
the JAX package's.

Tolerances: optimizer params and state rtol 1e-6 / atol 1e-7 over 5 steps
on the same params and gradients (float32 sums in another order); the
train step rtol 1e-5 / atol 1e-6 on params after 3 steps (a loss written
in each framework; gradients through another autodiff); compression bit
for bit (the same float32 divisions, round half to even); the mesh step
bit for bit to the port's own step on one device.

``shard_batch``, ``make_jitted_step`` and ``make_cross_pod_psum`` run on
4 gloo ranks (``tests/torch_mesh_ranks.py``, suite ``train``), one world
for this module; the cross-pod sum is held to the numpy formula (one
shared scale, an int32 sum of the codes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as W
from repro.train import compression as JC
from repro.train import optimizer as JO
from repro.train import train_loop as JTL
from repro_torch.data import pipeline as PL
from repro_torch.data.tokens import lm_iterator
from repro_torch.launch.mesh import PartitionSpec as P
from repro_torch.train import checkpoint as CK
from repro_torch.train import compression as TC
from repro_torch.train import optimizer as TO
from repro_torch.train import train_loop as TTL

OPT_RTOL, OPT_ATOL = 1e-6, 1e-7
STEP_RTOL, STEP_ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _flat(tree, prefix=""):
    """(path, host array) pairs of a tree of JAX arrays or tensors."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flat(tree[k], f"{prefix}/{k}")
        return out
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree.detach().float().numpy()
                 if tree.dtype == torch.bfloat16 else tree.detach().numpy())]
    return [(prefix, np.asarray(tree, np.float32)
             if tree.dtype == jnp.bfloat16 else np.asarray(tree))]


def assert_close(jtree, ttree, rtol, atol):
    j, t = _flat(jtree), _flat(ttree)
    assert [p for p, _ in j] == [p for p, _ in t]
    for (path, a), (_, b) in zip(j, t):
        assert a.shape == b.shape, path
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=path)


def assert_equal(jtree, ttree):
    j, t = _flat(jtree), _flat(ttree)
    assert [p for p, _ in j] == [p for p, _ in t]
    for (path, a), (_, b) in zip(j, t):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(b, a, err_msg=path)


def _params():
    """1-D, 2-D and stacked 3-D leaves."""
    rng = np.random.default_rng(0)
    return {"bias": rng.normal(size=7).astype(np.float32),
            "w": rng.normal(size=(5, 6)).astype(np.float32),
            "stack": rng.normal(size=(3, 4, 5)).astype(np.float32)}


def _grads(step):
    """Gradients of very different scales per layer of the stack, so the
    per-layer statistics and RMS clip matter."""
    rng = np.random.default_rng(100 + step)
    g = {"bias": rng.normal(size=7).astype(np.float32),
         "w": (rng.normal(size=(5, 6)) * 3).astype(np.float32),
         "stack": rng.normal(size=(3, 4, 5)).astype(np.float32)}
    g["stack"] *= np.float32([1e-3, 1.0, 30.0])[:, None, None]
    return g


def _both(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v.copy()) for k, v in tree.items()})


OPTIMIZERS = {
    "adamw": lambda m: m.adamw(
        peak_lr=1e-2, schedule=m.cosine_schedule(1e-2, warmup=2, total=6)),
    "adamw_default": lambda m: m.adamw(),
    "adamw_noclip": lambda m: m.adamw(
        peak_lr=3e-3, max_grad_norm=1e6, weight_decay=0.0,
        schedule=m.cosine_schedule(3e-3, warmup=0, total=4)),
    "adafactor": lambda m: m.adafactor(
        peak_lr=1e-2, schedule=m.cosine_schedule(1e-2, warmup=2, total=6)),
    "adafactor_wd": lambda m: m.adafactor(
        peak_lr=5e-3, weight_decay=0.01, clip_threshold=0.5,
        schedule=m.cosine_schedule(5e-3, warmup=1, total=8)),
    "adafactor_default": lambda m: m.adafactor(),
    "sgd": lambda m: m.sgd(0.05),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_jax_over_five_steps(name):
    jopt, topt = OPTIMIZERS[name](JO), OPTIMIZERS[name](TO)
    jp, tp = _both(_params())
    js, ts = jopt.init(jp), topt.init(tp)
    assert_equal(js, ts)
    assert ts["step"].dtype == torch.int32
    for step in range(5):
        jg, tg = _both(_grads(step))
        jp, js, jstats = jopt.update(jp, jg, js)
        tp, ts, tstats = topt.update(tp, tg, ts)
        assert_close(jp, tp, OPT_RTOL, OPT_ATOL)
        assert_close(js, ts, OPT_RTOL, OPT_ATOL)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        assert sorted(tstats) == sorted(jstats)
        assert_close(jstats, tstats, OPT_RTOL, OPT_ATOL)
    for leaf in (tp, ts):
        for _, x in _flat(leaf):
            assert np.isfinite(x).all()


def test_adafactor_stacked_leaf_updates_layer_by_layer():
    """A stacked (L, d, d) leaf's update is L independent 2-D updates: its
    factored statistics and its RMS clip are per layer."""
    opt = TO.adafactor(peak_lr=1e-2, schedule=TO.cosine_schedule(
        1e-2, warmup=0, total=10))
    p = torch.from_numpy(_params()["stack"])
    state = opt.init({"s": p})
    g = torch.from_numpy(_grads(0)["stack"])
    new, new_state, _ = opt.update({"s": p}, {"s": g}, state)
    for i in range(p.shape[0]):
        one, one_state, _ = opt.update(
            {"s": p[i]}, {"s": g[i]}, opt.init({"s": p[i]}))
        assert torch.equal(new["s"][i], one["s"])
        for k in ("vr", "vc"):
            assert torch.equal(new_state["stats"]["s"][k][i],
                               one_state["stats"]["s"][k])


def test_adafactor_state_specs_match_jax():
    from jax.sharding import PartitionSpec as JP
    jspec = JO.adafactor().state_specs(
        {"w": JP("data", "model"), "s": JP(None, "data", "model"),
         "b": JP("model")})
    tspec = TO.adafactor().state_specs(
        {"w": P("data", "model"), "s": P(None, "data", "model"),
         "b": P("model")})
    assert tuple(tspec["step"]) == tuple(jspec["step"]) == ()
    for k in ("w", "s", "b"):
        for f in jspec["stats"][k]:
            assert tuple(tspec["stats"][k][f]) == tuple(jspec["stats"][k][f])
    a = TO.adamw().state_specs({"w": P("data")})
    assert a["m"]["w"] == a["v"]["w"] == P("data") and len(a["step"]) == 0
    assert len(TO.sgd().state_specs({"w": P("data")})["step"]) == 0


@pytest.mark.parametrize("kw", [dict(peak_lr=1e-3),
                                dict(peak_lr=2.0, warmup=7, total=31,
                                     floor=0.3),
                                dict(peak_lr=0.5, warmup=0, total=1)])
def test_cosine_schedule_matches_jax(kw):
    jl, tl = JO.cosine_schedule(**kw), TO.cosine_schedule(**kw)
    for s in (0, 1, 3, 7, 8, 30, 31, 99, 100, 101, 5000, 9999, 10000, 20000):
        want = np.asarray(jl(jnp.int32(s)))
        got = tl(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=OPT_RTOL,
                                   atol=OPT_ATOL)


@pytest.mark.parametrize("max_norm", [0.5, 1.0, 1e6])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _grads(3)
    jg, tg = _both(g)
    jg["half"] = jnp.asarray(g["w"], jnp.bfloat16)
    tg["half"] = torch.from_numpy(g["w"]).to(torch.bfloat16)
    jc, jn = JO.clip_by_global_norm(jg, max_norm)
    tc, tn = TO.clip_by_global_norm(tg, max_norm)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=OPT_RTOL)
    np.testing.assert_allclose(TO.global_norm(tg).numpy(),
                               np.asarray(JO.global_norm(jg)), rtol=OPT_RTOL)
    assert tc["half"].dtype == torch.bfloat16
    assert_close(jc, tc, OPT_RTOL, OPT_ATOL)


# -- the train step ---------------------------------------------------------

def jlm_loss(params, batch):
    """``torch_mesh_ranks.lm_loss`` written in JAX."""
    h = params["emb"][batch["tokens"]]
    for i in range(params["stack"].shape[0]):
        h = jnp.tanh(h @ params["stack"][i]) + h
    logits = h @ params["out"] + params["bias"]
    logp = jax.nn.log_softmax(logits, axis=-1)
    return -jnp.take_along_axis(logp, batch["labels"][..., None],
                                axis=-1).mean()


def _data(start=0):
    return lm_iterator(global_batch=W.LM["batch"], seq_len=W.LM["seq"],
                       vocab=W.LM["vocab"], start_step=start)


@pytest.mark.parametrize("accum", [1, 4])
@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_train_step_matches_jax(accum, opt):
    mk = lambda m: (m.adamw(peak_lr=1e-2, schedule=m.cosine_schedule(
        1e-2, warmup=1, total=10)) if opt == "adamw" else
        m.adafactor(peak_lr=1e-2))
    jopt, topt = mk(JO), mk(TO)
    jp, tp = _both(W.lm_params())
    js, ts = jopt.init(jp), topt.init(tp)
    jstep = jax.jit(JTL.make_train_step(jlm_loss, jopt, accum=accum))
    tstep = TTL.make_train_step(W.lm_loss, topt, accum=accum)
    for b in (next(it) for it in [_data()] for _ in range(3)):
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = tstep(tp, ts, b)                 # numpy batch leaves
        np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                                   rtol=STEP_RTOL)
    assert_close(jp, tp, STEP_RTOL, STEP_ATOL)
    assert_close(js, ts, STEP_RTOL, STEP_ATOL)


def test_accumulation_matches_one_batch():
    """``accum=4`` sums four microbatch gradients in order and divides by 4:
    the mean loss's gradient, up to float32 rounding."""
    opt = TO.sgd(0.1)
    p = {k: torch.from_numpy(v) for k, v in W.lm_params().items()}
    batch = next(_data())
    p1, _, m1 = TTL.make_train_step(W.lm_loss, opt)(p, opt.init(p), batch)
    p4, _, m4 = TTL.make_train_step(W.lm_loss, opt, accum=4)(
        p, opt.init(p), batch)
    torch.testing.assert_close(m4["loss"], m1["loss"], rtol=STEP_RTOL,
                               atol=0)
    for k in p:
        torch.testing.assert_close(p4[k], p1[k], rtol=STEP_RTOL,
                                   atol=STEP_ATOL)
    with pytest.raises(ValueError, match="microbatches"):
        TTL.make_train_step(W.lm_loss, opt, accum=3)(p, opt.init(p), batch)
    bf = TTL.make_train_step(W.lm_loss, opt, accum=4,
                             accum_dtype=torch.bfloat16, donate=False)
    pb, _, _ = bf(p, opt.init(p), batch)
    assert all(pb[k].dtype == torch.float32 for k in p)


def test_eval_step_and_train_hooks_resume_bit_for_bit(tmp_path):
    opt = TO.adamw(peak_lr=5e-3, schedule=TO.cosine_schedule(
        5e-3, warmup=2, total=20))
    p0 = {k: torch.from_numpy(v) for k, v in W.lm_params().items()}
    s0 = opt.init(p0)
    step = TTL.make_train_step(W.lm_loss, opt)
    ev = TTL.make_eval_step(W.lm_loss)
    b = next(_data())
    assert torch.equal(ev(p0, b), W.lm_loss(p0, {
        k: torch.from_numpy(v) for k, v in b.items()}))

    seen = []
    hook = lambda i, p, s, m: seen.append((i, float(m["loss"]),
                                           int(s["step"])))
    ck = CK.CheckpointHook(str(tmp_path), interval=3)
    p1, s1, m1 = TTL.train(p0, s0, step, _data(), n_steps=6,
                           hooks=[hook, ck])
    ck.flush()
    assert [i for i, _, _ in seen] == list(range(6))
    assert [k for _, _, k in seen] == list(range(1, 7))
    assert seen[-1][1] < seen[0][1]
    assert CK.all_steps(str(tmp_path)) == [3, 6]
    # restore step 6, go on to 9; the unbroken run: the same bits
    like = {"params": p0, "opt": s0}
    restored, at = CK.restore(str(tmp_path), 6, like, device="cpu")
    assert at == 6
    seen.clear()
    p2, s2, _ = TTL.train(restored["params"], restored["opt"], step,
                          _data(start=6), n_steps=9, start_step=6,
                          hooks=[hook])
    assert [i for i, _, _ in seen] == [6, 7, 8]
    p3, s3, _ = TTL.train(p1, s1, step, _data(start=6), n_steps=9,
                          start_step=6)
    assert_equal(p3, p2)
    assert_equal(s3, s2)


# -- compression ------------------------------------------------------------

def _comp_grads(step):
    rng = np.random.default_rng(step)
    g = {"a": rng.normal(size=(6, 9)).astype(np.float32),
         "b": (rng.normal(size=40) * 1e-3).astype(np.float32),
         "ties": np.float32([3, -3, 3, 1, 0, -1, 2, 2, -2, 0.5])}
    return g


@pytest.mark.parametrize("method", ["int8", "topk"])
def test_compression_is_bit_identical_with_error_feedback(method):
    jp, tp = _both(_comp_grads(0))
    jef, tef = JC.init_error_feedback(jp), TC.init_error_feedback(tp)
    assert_equal(jef, tef)
    for step in range(3):
        jg, tg = _both(_comp_grads(step))
        if method == "int8":
            (jc, jef), (tc, tef) = (JC.compress_int8(jg, jef),
                                    TC.compress_int8(tg, tef))
        else:
            (jc, jef), (tc, tef) = (JC.compress_topk(jg, jef, frac=0.2),
                                    TC.compress_topk(tg, tef, frac=0.2))
        assert_equal(jc, tc)
        assert_equal(jef, tef)


def test_quantize_rounds_half_to_even_like_jax():
    x = np.float32([127, 0.5, 1.5, 2.5, -2.5, -0.5, 3.5, 126.5, -127, 0])
    jq, js = JC.quantize_int8(jnp.asarray(x))
    tq, ts = TC.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and float(ts) == 1.0
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tq.numpy()[1:7], [0, 2, 2, -2, 0, 4])
    np.testing.assert_array_equal(TC.dequantize_int8(tq, ts).numpy(),
                                  np.asarray(JC.dequantize_int8(jq, js)))
    zq, zs = TC.quantize_int8(torch.zeros(4))
    assert float(zs) == np.float32(1e-12) / np.float32(127.0)
    assert not zq.any()


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.35, 1.0])
def test_topk_mask_keeps_ties(frac):
    x = _comp_grads(5)["ties"]
    want = np.asarray(JC.topk_mask(jnp.asarray(x), frac))
    got = TC.topk_mask(torch.from_numpy(x), frac)
    np.testing.assert_array_equal(got.numpy(), want)
    if frac == 0.1:                              # k = 1: both 3s and the -3
        np.testing.assert_array_equal(np.flatnonzero(got.numpy()), [0, 1, 2])


@pytest.mark.parametrize("method", ["int8", "topk", "none"])
def test_compressed_bytes_match_jax(method):
    jg, tg = _both(_comp_grads(1))
    assert TC.compressed_bytes(tg, method, frac=0.05) == \
        JC.compressed_bytes(jg, method, frac=0.05)


def test_prefetcher_keeps_order_and_ends():
    pf = PL.Prefetcher(iter(range(20)), depth=2, place=lambda x: x * 2)
    assert list(pf) == [2 * i for i in range(20)]
    pf.thread.join(timeout=10)
    assert not pf.thread.is_alive()
    # an empty source ends at once
    assert list(PL.Prefetcher(iter(()))) == []


# -- on 4 gloo ranks: shard_batch, make_jitted_step, make_cross_pod_psum ----

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return W.start("train", 4, tmp_path_factory.mktemp("train")).results()


def test_shard_batch_places_each_rank_its_shard(world):
    b = next(_data())
    x = np.arange(16, dtype=np.int32)
    for res in world:
        d, m = res["coord"]
        np.testing.assert_array_equal(res["shard.tokens.local"],
                                      b["tokens"][4 * d:4 * (d + 1)])
        np.testing.assert_array_equal(res["shard.labels.local"],
                                      b["labels"][:, 8 * m:8 * (m + 1)])
        np.testing.assert_array_equal(res["shard.tokens.full"], b["tokens"])
        np.testing.assert_array_equal(res["shard.labels.full"], b["labels"])
        i = 2 * d + m                             # data major, model minor
        np.testing.assert_array_equal(res["shard.both.local"],
                                      x[4 * i:4 * (i + 1)])
        # an unknown axis, an axis twice, axes out of the mesh's order, a
        # spec longer than the tensor
        np.testing.assert_array_equal(res["shard.raised"], [1, 1, 1, 1])


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_jitted_step_equals_the_step_on_one_device(world, name):
    opt = (TO.adamw(peak_lr=1e-2, schedule=TO.cosine_schedule(
        1e-2, warmup=1, total=10)) if name == "adamw"
        else TO.adafactor(peak_lr=1e-2))
    step = TTL.make_train_step(W.lm_loss, opt, accum=2)
    p = {k: torch.from_numpy(v) for k, v in W.lm_params().items()}
    s = opt.init(p)
    losses = []
    for b in (next(it) for it in [_data()] for _ in range(W.TRAIN_STEPS)):
        p, s, m = step(p, s, b)
        losses.append(m["loss"].numpy())
    param_specs, _ = W.train_specs()
    for res in world:
        d, mdl = res["coord"]
        for i, loss in enumerate(losses):
            np.testing.assert_array_equal(res[f"jit.{name}.loss.{i}"], loss)
        for k, v in p.items():
            np.testing.assert_array_equal(res[f"jit.{name}.param.{k}"],
                                          v.numpy())
            idx = []
            for ax, n in zip(list(param_specs[k]) + [None] * v.ndim,
                             v.shape):
                c = {"data": d, "model": mdl}.get(ax)
                idx.append(slice(None) if c is None else
                           slice(c * n // 2, (c + 1) * n // 2))
            np.testing.assert_array_equal(res[f"jit.{name}.local.{k}"],
                                          v.numpy()[tuple(idx)])
        assert res[f"jit.{name}.wrong_layout_raised"] == 1
        if name == "adafactor":
            vr = s["stats"]["stack"]["vr"].numpy()
            np.testing.assert_array_equal(res["jit.adafactor.vr.local"],
                                          vr[:, 4 * d:4 * (d + 1)])
            assert list(res["jit.adafactor.vr.placements"]) == ["S(1)", "R"]


def test_cross_pod_psum_is_the_shared_scale_int32_sum(world):
    # the (pod, data) mesh is ranks [[0, 1], [2, 3]]: pods {0, 2}, {1, 3}
    for r, res in enumerate(world):
        group = [r % 2, r % 2 + 2]
        gs = [W.psum_input(q) for q in group]
        scale = np.maximum(np.float32(max(np.abs(g).max() for g in gs))
                           / np.float32(127.0), np.float32(1e-12))
        codes = [np.clip(np.round(g / scale), -127, 127).astype(np.int8)
                 for g in gs]
        qsum = sum(c.astype(np.int32) for c in codes)
        want = (qsum.astype(np.float32) * scale).astype(np.float32)
        np.testing.assert_array_equal(res["psum.int8"], want)
        np.testing.assert_array_equal(res["psum.none"], gs[0] + gs[1])
        assert res["psum.no_pod_raised"] == 1
