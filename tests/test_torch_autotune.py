"""The port's roofline autotuner (``repro_torch/core/autotune.py``) and
its launch helpers against the JAX package on the CPU.

  * With one explicit shared ``BackendProfile``, static plans equal the
    JAX package's (``to_dict()`` and ``checksum()``), and so do
    ``graph_stats``, ``form_units``, ``pinned_direction``, ``tune_tiles``
    at n_pad 128-1,024 and the fields ``apply`` overlays.  At n_pad 2,048
    the JAX package's whole-operand fused gate closes and the port's stays
    open: ``fused_steps`` is the one field that differs.
  * Under one plan saved by the JAX package (a static one, and one with
    hand-set unit costs that move the overlay's ``c_pull`` / ``c_sparse``
    off 8), each engine gives ``dist``, ``sigma``, ``sweeps``,
    ``direction_counts`` and ``edges_touched`` bit-identical to JAX on
    the reference path (pinned by the plan), under the dynamic switch and
    on the kernel path with fusion (the JAX kernels in interpret mode, the
    port's wrappers on their plain versions).
  * The cases of ``tests/test_autotune.py`` on the port: tuned == default,
    the determinism lock, the analytic argmin, serialization (across the
    packages too), the budget check, tile clamping, hashability and the
    facade.
  * The op counter and the roofline terms behind ``build_plan``.
"""
import dataclasses
import importlib
import json

import numpy as np
import pytest
import torch

from oracles import adversarial_families
from repro.core import autotune as jat
from repro.graph.csr import CSRGraph as JCSR
from repro.launch import roofline as jroof
import repro_torch
from repro_torch.convert import csr_from_arrays
from repro_torch.core import autotune as tat
from repro_torch.kernels import common as kernel_common
from repro_torch.kernels import registry as kernel_registry
from repro_torch.launch import op_analysis
from repro_torch.launch import roofline as troof

jeng = importlib.import_module("repro.core.engine")
teng = importlib.import_module("repro_torch.core.engine")
jw = importlib.import_module("repro.core.weighted")
tw = importlib.import_module("repro_torch.core.weighted")
jcent = importlib.import_module("repro.core.centrality")
tcent = importlib.import_module("repro_torch.core.centrality")
tsweep = importlib.import_module("repro_torch.core.sweep")

ARRAYS = ("indptr", "indices", "src", "dst", "indptr_t", "indices_t")
FAMILIES = {name: (src, dst, n) for name, src, dst, n in
            adversarial_families(seed=0)}
# one profile for both packages: the JAX package's CPU figures and its
# 16 MB budget, under which its tiles reach 512 at these sizes
SHARED = dict(name="cpu:cpu", peak_flops=2.0e11, hbm_bw=5.0e10,
              vmem_budget=16 * 2 ** 20)
JPROF = jat.BackendProfile(**SHARED)
TPROF = tat.BackendProfile(**SHARED)
# hand-set per-unit seconds: the overlay's c_pull / c_sparse land well
# away from the engines' defaults of 8, so that these small graphs, where
# the default constants take the sparse form in every sweep, pin and
# switch between the dense forms
UNIT = 2.0 ** -40
HAND_COSTS = {("boolean", "push"): UNIT, ("boolean", "pull"): 2.5 * UNIT,
              ("boolean", "sparse"): 300 * UNIT,
              ("counting", "push"): UNIT, ("counting", "sparse"): 300 * UNIT,
              ("tropical", "dense"): UNIT, ("tropical", "sparse"): 300 * UNIT}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def carry(jg):
    return csr_from_arrays({k: np.asarray(getattr(jg, k)) for k in ARRAYS},
                           n_nodes=jg.n_nodes, n_edges=jg.n_edges,
                           m_pad=jg.m_pad, device="cpu")


def graphs(family):
    src, dst, n = FAMILIES[family]
    jg = JCSR.from_edges(src, dst, n)
    return jg, carry(jg)


def family_weights(jg):
    gs, gd = jg.edge_arrays_np()
    w = np.full(jg.m_pad, 1.0, np.float32)
    w[: jg.n_edges] = ((gs * 7 + gd * 3) % 9 + 1).astype(np.float32)
    return w


def sources_of(n):
    return np.unique(np.clip([0, 1, n // 2, n - 1], 0, n - 1)).astype(
        np.int32)


# --------------------------------------------------------------------------
# static plans equal the JAX package's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_static_plan_matches_jax(family):
    jg, tg = graphs(family)
    jp = jat.build_plan(jg, profile=JPROF, use_hlo=False)
    tp = tat.build_plan(tg, profile=TPROF, use_hlo=False)
    assert tp.to_dict() == jp.to_dict()
    assert tp.checksum() == jp.checksum()
    assert tuple(tat.graph_stats(tg)) == tuple(jat.graph_stats(jg))
    st = tp.graph
    for semiring, vocab in tat.FORM_VOCAB.items():
        assert vocab == jat.FORM_VOCAB[semiring]
        for s in (8, 32, 128):
            kw = dict(s=s, n_pad=st.n_pad, m_pad=st.m_pad)
            assert tp.pinned_direction(semiring, **kw) == \
                jp.pinned_direction(semiring, **kw)
            for form in vocab:
                assert tat.form_units(form, **kw) == \
                    jat.form_units(form, **kw)


@pytest.mark.parametrize("n_pad", [128, 256, 384, 512, 640, 768, 896, 1024])
def test_tune_tiles_matches_jax(n_pad):
    assert tat.tune_tiles(TPROF, n_pad=n_pad) == \
        jat.tune_tiles(JPROF, n_pad=n_pad)
    # the card's budget leaves the tiles and the gate as they are here
    assert tat.tune_tiles(tat.STATIC_PROFILES["cuda"], n_pad=n_pad) == \
        tat.tune_tiles(TPROF, n_pad=n_pad)


def test_fused_gate_is_the_one_divergence_at_2048():
    """JAX's whole-operand VMEM gate closes at n_pad 2,048 (tropical stops
    at 1,792, counting at 3,072); the port's fused kernels hold a block's
    share, so its gate stays open — the only field that differs."""
    assert jat.tune_tiles(JPROF, n_pad=2048) == (128, 512, 512, 0)
    assert tat.tune_tiles(TPROF, n_pad=2048) == (128, 512, 512, -1)
    rng = np.random.default_rng(5)
    jg = JCSR.from_edges(rng.integers(0, 2000, 6000),
                         rng.integers(0, 2000, 6000), 2000)
    jp = jat.build_plan(jg, profile=JPROF, use_hlo=False)
    tp = tat.build_plan(carry(jg), profile=TPROF, use_hlo=False)
    assert jp.graph.n_pad == 2048
    jd, td = jp.to_dict(), tp.to_dict()
    assert {k for k in jd if jd[k] != td[k]} == {"fused_steps"}
    assert (jd["fused_steps"], td["fused_steps"]) == (0, -1)


def hand_plans(jg):
    """(name, JAX plan) pairs: a static plan and one with HAND_COSTS."""
    jp = jat.build_plan(jg, profile=JPROF, use_hlo=False)
    hand = dataclasses.replace(jp, unit_costs=tuple(
        (sr, f, HAND_COSTS[(sr, f)]) for sr, f, _ in jp.unit_costs))
    return [("static", jp), ("hand", hand)]


CONFIG_PAIRS = [("boolean", jeng.EngineConfig, teng.EngineConfig),
                ("tropical", jw.WeightedConfig, tw.WeightedConfig),
                ("counting", jcent.CentralityConfig, tcent.CentralityConfig)]


@pytest.mark.parametrize("n_pad", [128, 256, 384, 512])
def test_apply_fields_match_jax(n_pad):
    jg, _ = graphs("random_ragged")                  # plan at n_pad 256
    for _, jp in hand_plans(jg):
        tp = tat.TuningPlan.from_dict(jp.to_dict())
        for semiring, jcls, tcls in CONFIG_PAIRS:
            for extra in ({}, {"fused_steps": 3}, {"bn": 256}):
                jc = jat.apply(jcls(tuning=jp, **extra), semiring=semiring,
                               n_pad=n_pad)
                tc = tat.apply(tcls(tuning=tp, **extra), semiring=semiring,
                               n_pad=n_pad)
                for f in dataclasses.fields(tcls):
                    if f.name != "tuning":
                        assert getattr(tc, f.name) == getattr(jc, f.name), \
                            (semiring, extra, f.name)
    # the hand-set costs move the overlay off the defaults
    tc = tat.apply(teng.EngineConfig(tuning=tat.TuningPlan.from_dict(
        hand_plans(jg)[1][1].to_dict())), semiring="boolean")
    assert (tc.c_push, tc.c_pull, tc.c_sparse) == (1.0, 2.5, 300.0)


# --------------------------------------------------------------------------
# a JAX-saved plan runs the same in the port
# --------------------------------------------------------------------------

PATHS = {
    "ref": dict(use_kernel=False),                   # pinned by the plan
    "dynamic": dict(use_kernel=False, dynamic=True),
    "fused": dict(use_kernel=True),                  # the plan's fused gate
}
# the fused path runs the JAX kernels in interpret mode: fewer families
PLAN_FAMILIES = {"ref": ("random_ragged", "path", "two_components",
                         "star_in", "clique"),
                 "dynamic": ("random_ragged", "path", "two_components",
                             "star_in", "clique"),
                 "fused": ("random_ragged", "two_components")}


def load_both(jp, tmp_path):
    path = tmp_path / "plan.json"
    jp.save(path)
    return jat.TuningPlan.load(path), tat.TuningPlan.load(path,
                                                          device="cpu")


def run_engines(semiring, jg, tg, sources, jcfg, tcfg):
    if semiring == "boolean":
        return (jeng.apsp_engine(jg, sources, config=jcfg),
                teng.apsp_engine(teng.prepare_graph(tg, device="cpu"),
                                 sources, config=tcfg))
    if semiring == "tropical":
        w = family_weights(jg)
        return (jw.weighted_apsp(jg, w, sources, config=jcfg),
                tw.weighted_apsp(tw.prepare_weighted(tg, w, device="cpu"),
                                 sources=sources, config=tcfg))
    return (jcent.counting_apsp(jg, sources, config=jcfg),
            tcent.counting_apsp(teng.prepare_graph(tg, device="cpu"),
                                sources, config=tcfg))


def assert_same_run(rj, rt):
    np.testing.assert_array_equal(np.asarray(rj.dist), rt.dist.numpy())
    if hasattr(rj, "sigma"):
        np.testing.assert_array_equal(np.asarray(rj.sigma),
                                      rt.sigma.numpy())
    assert int(rj.sweeps) == rt.sweeps
    np.testing.assert_array_equal(np.asarray(rj.direction_counts),
                                  rt.direction_counts.numpy())
    if hasattr(rj, "edges_touched"):
        assert np.float32(rj.edges_touched).tobytes() == \
            rt.edges_touched.numpy().astype(np.float32).tobytes()


@pytest.mark.parametrize("plan_kind", ["static", "hand"])
@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("semiring", ["boolean", "counting", "tropical"])
def test_jax_saved_plan_runs_the_same(semiring, path, plan_kind, tmp_path):
    jcls, tcls = {s: (j, t) for s, j, t in CONFIG_PAIRS}[semiring]
    for family in PLAN_FAMILIES[path]:
        jg, tg = graphs(family)
        jp, tp = load_both(dict(hand_plans(jg))[plan_kind], tmp_path)
        assert tp.to_dict() == jp.to_dict()
        sources = np.arange(jg.n_nodes, dtype=np.int32)[::-1][:24]
        kw = dict(source_batch=16, **PATHS[path])
        rj, rt = run_engines(semiring, jg, tg, sources,
                             jcls(tuning=jp, **kw), tcls(tuning=tp, **kw))
        assert_same_run(rj, rt)
        counts = rt.direction_counts.numpy()
        if path == "ref":          # every sweep in the plan's argmin form
            want = tp.pinned_direction(semiring, s=16, n_pad=tp.graph.n_pad,
                                       m_pad=tp.graph.m_pad)
            assert counts[want] == counts.sum(), (family, counts, want)


# --------------------------------------------------------------------------
# tuning may change speed, never results (tests/test_autotune.py)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True], ids=["ref", "kernel"])
@pytest.mark.parametrize("semiring", ["boolean", "counting", "tropical"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tuned_equals_default(family, semiring, use_kernel):
    jg, tg = graphs(family)
    plan = tat.build_plan(tg, use_hlo=False)
    sources = sources_of(tg.n_nodes)
    cls = {s: t for s, _, t in CONFIG_PAIRS}[semiring]
    base_cfg = cls(source_batch=8, use_kernel=use_kernel)
    tuned_cfg = dataclasses.replace(base_cfg, tuning=plan)
    if semiring == "tropical":
        pw = tw.prepare_weighted(tg, family_weights(jg), device="cpu")
        base = tw.weighted_apsp(pw, sources=sources, config=base_cfg)
        tuned = tw.weighted_apsp(pw, sources=sources, config=tuned_cfg)
    else:
        pg = teng.prepare_graph(tg, device="cpu")
        run = teng.apsp_engine if semiring == "boolean" else \
            tcent.counting_apsp
        base = run(pg, sources, config=base_cfg)
        tuned = run(pg, sources, config=tuned_cfg)
    assert torch.equal(base.dist, tuned.dist), family
    assert base.sweeps == tuned.sweeps, family
    if semiring == "counting":
        assert torch.equal(base.sigma, tuned.sigma), family
    if semiring == "boolean":
        assert torch.equal(tsweep.derive_parents(tg, base.dist),
                           tsweep.derive_parents(tg, tuned.dist)), family


def test_auto_direction_counts_deterministic_with_plan():
    """Two identical mode="auto" runs under one plan report the same
    direction_counts, every sweep in the plan's analytic argmin form."""
    jg, tg = graphs("random_ragged")
    plan = tat.build_plan(tg, use_hlo=False)
    cfg = teng.EngineConfig(source_batch=16, mode="auto", use_kernel=False,
                            tuning=plan)
    pg = teng.prepare_graph(tg, device="cpu")
    r1 = teng.apsp_engine(pg, config=cfg)
    r2 = teng.apsp_engine(pg, config=cfg)
    assert torch.equal(r1.direction_counts, r2.direction_counts)
    want = plan.pinned_direction("boolean", s=16, n_pad=pg.n_pad,
                                 m_pad=tg.m_pad)
    counts = r1.direction_counts.numpy()
    assert counts.sum() > 0 and counts[want] == counts.sum(), (counts, want)
    # the wall clock was never read: nothing was calibrated
    assert pg.cost_cache == {}


@pytest.mark.parametrize("semiring", sorted(tat.FORM_VOCAB))
def test_pinned_direction_is_analytic_argmin(semiring):
    _, tg = graphs("path")
    plan = tat.build_plan(tg, use_hlo=False)
    st = tat.graph_stats(tg)
    idx = plan.pinned_direction(semiring, s=8, n_pad=st.n_pad,
                                m_pad=st.m_pad)
    costs = [plan.unit_cost(semiring, f)
             * tat.form_units(f, s=8, n_pad=st.n_pad, m_pad=st.m_pad)
             for f in tat.FORM_VOCAB[semiring]]
    assert idx == int(np.argmin(costs))
    assert 0 <= idx < len(tat.FORM_VOCAB[semiring])


# --------------------------------------------------------------------------
# serialization
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_plan_save_load_roundtrip(tmp_path, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 200))
    m = int(rng.integers(1, 4 * n))
    jg = JCSR.from_edges(rng.integers(0, n, m), rng.integers(0, n, m), n)
    plan = tat.build_plan(carry(jg), use_hlo=False)
    path = tmp_path / "plan.json"
    plan.save(path)
    loaded = tat.TuningPlan.load(path, device="cpu")
    assert loaded == plan and loaded.checksum() == plan.checksum()
    with open(path) as f:
        raw = json.load(f)
    assert raw["version"] == tat.PLAN_VERSION
    assert tat.TuningPlan.from_dict(raw) == plan
    # the JAX package reads the port's plan file, to the same dict
    jplan = jat.TuningPlan.load(path)
    assert jplan.to_dict() == plan.to_dict()
    assert jplan.checksum() == plan.checksum()


def test_plan_load_refuses_foreign_fingerprint(tmp_path):
    _, tg = graphs("tiny")
    plan = tat.build_plan(tg, use_hlo=False)
    assert plan.backend == "cpu:cpu" == tat.device_fingerprint("cpu")
    alien = dataclasses.replace(plan, backend="cuda:imaginary-card")
    path = tmp_path / "alien.json"
    alien.save(path)
    with pytest.raises(ValueError, match="fingerprint"):
        tat.TuningPlan.load(path, device="cpu")
    assert tat.TuningPlan.load(path, allow_mismatch=True,
                               device="cpu") == alien


def test_plan_load_refuses_wrong_version(tmp_path):
    _, tg = graphs("tiny")
    d = tat.build_plan(tg, use_hlo=False).to_dict()
    d["version"] = 999
    path = tmp_path / "future.json"
    with open(path, "w") as f:
        json.dump(d, f)
    with pytest.raises(ValueError, match="version"):
        tat.TuningPlan.load(path, device="cpu")


# --------------------------------------------------------------------------
# the budget, the tiles, the overlay
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_pad", [128, 256, 512, 1024, 4096, 65664])
def test_emitted_plan_fits_the_budget(n_pad):
    """The tiles divide n_pad, and with the gate open one block of every
    fused kernel fits the card's shared memory."""
    prof = tat.backend_profile("cpu:cpu")
    assert prof.vmem_budget == kernel_common.SMEM_BUDGET_BYTES
    bs, bn, bk, fused = tat.tune_tiles(prof, n_pad=n_pad)
    assert n_pad % bn == 0 and n_pad % bk == 0
    assert bn == bk == kernel_common.tile_candidates(n_pad)[0]
    assert fused == -1
    for semiring in kernel_registry.available():
        ks = kernel_registry.get(semiring)
        for _ in ks.fused_forms:
            assert ks.smem_bytes(form="fused", bs=bs, n=n_pad) <= \
                prof.vmem_budget, semiring


def test_plan_validate_rejects_a_tiny_budget():
    _, tg = graphs("random_ragged")
    plan = tat.build_plan(tg, use_hlo=False)
    plan.validate()                      # the emitted plan passes
    with pytest.raises(ValueError, match="shared-memory budget"):
        dataclasses.replace(plan, vmem_budget=1024).validate()
    # the gate closes where the boolean fused block outgrows the card
    big = tat.tune_tiles(tat.STATIC_PROFILES["cuda"], n_pad=264_832)
    assert big[3] == 0
    dataclasses.replace(plan, vmem_budget=1024, fused_steps=0).validate()


def test_apply_clamps_foreign_tiles_to_divisors():
    big = carry(JCSR.from_edges([0], [1], 500))           # n_pad 512
    plan = tat.build_plan(big, use_hlo=False)
    assert (plan.bn, plan.bk) == (512, 512)
    cfg = teng.EngineConfig(tuning=plan)
    small = tat.apply(cfg, semiring="boolean", n_pad=256)
    assert (small.bn, small.bk) == (128, 128)
    same = tat.apply(cfg, semiring="boolean", n_pad=512)
    assert (same.bn, same.bk) == (512, 512)
    explicit = tat.apply(teng.EngineConfig(tuning=plan, fused_steps=3),
                         semiring="boolean", n_pad=512)
    assert explicit.fused_steps == 3
    assert same.fused_steps == plan.fused_steps == -1


def test_apply_without_plan_is_identity():
    cfg = teng.EngineConfig(source_batch=32)
    assert tat.apply(cfg, semiring="boolean", n_pad=256) is cfg


def test_fused_budget_is_capped_on_the_card():
    jg, _ = graphs("tiny")
    plan = tat.TuningPlan.from_dict(
        jat.build_plan(jg, use_hlo=False).to_dict())      # 16 MB budget
    cfg = teng.EngineConfig(tuning=plan)
    assert tat.fused_budget(teng.EngineConfig(), "cpu") is None
    assert tat.fused_budget(cfg, "cpu") == 16 * 2 ** 20
    assert tat.fused_budget(cfg, "cuda") == kernel_common.SMEM_BUDGET_BYTES


def test_plan_is_hashable():
    _, tg = graphs("tiny")
    cfg = teng.EngineConfig(tuning=tat.build_plan(tg, use_hlo=False))
    assert hash(cfg) == hash(dataclasses.replace(cfg))
    assert cfg == dataclasses.replace(cfg)


# --------------------------------------------------------------------------
# the facade
# --------------------------------------------------------------------------

def test_facade_tune_and_reload(tmp_path):
    jg, tg = graphs("two_components")
    h = repro_torch.prepare(tg, source_batch=8, mode="auto",
                            use_kernel=False, device="cpu")
    path = tmp_path / "plan.json"
    plan = h.tune(use_hlo=False, save=path)
    assert h.tuning is plan and plan.source == "static"
    r1 = h.apsp()
    h2 = repro_torch.prepare(tg, source_batch=8, mode="auto",
                             use_kernel=False, tuning=str(path),
                             device="cpu")
    assert h2.tuning == plan
    r2 = h2.apsp()
    assert torch.equal(r1.dist, r2.dist)
    assert torch.equal(r1.direction_counts, r2.direction_counts)
    # the config the facade builds for the serving tier carries the plan
    assert h2.serve(n_landmarks=0).config.tuning == plan


def test_facade_tune_prices_every_semiring(tmp_path):
    jg, tg = graphs("random_ragged")
    w = family_weights(jg)
    h = repro_torch.prepare(tg, weights=w, device="cpu", use_kernel=False)
    plan = h.tune(save=tmp_path / "p.json")
    assert plan.source == "ops" and plan.backend == "cpu:cpu"
    assert all(plan.covers(sr) for sr in tat.FORM_VOCAB)
    assert all(np.isfinite(c) and c > 0 for _, _, c in plan.unit_costs)
    rt = h.apsp(range(16), semiring="tropical")
    rj = jw.weighted_apsp(jg, w, np.arange(16, dtype=np.int32),
                          config=jw.WeightedConfig(source_batch=128,
                                                   use_kernel=False,
                                                   mode="sparse"))
    np.testing.assert_array_equal(np.asarray(rj.dist), rt.dist.numpy())
    alien = tmp_path / "alien.json"
    dataclasses.replace(plan, backend="cuda:imaginary-card").save(alien)
    with pytest.raises(ValueError, match="fingerprint"):
        repro_torch.prepare(tg, device="cpu", tuning=str(alien))


# --------------------------------------------------------------------------
# the op counter and the roofline terms
# --------------------------------------------------------------------------

def test_op_counts_of_a_matmul_are_exact():
    a, b = torch.ones(8, 16), torch.ones(16, 32)
    st = op_analysis.analyze_callable(lambda x, y: x @ y, a, b)
    assert st.flops == 2 * 8 * 16 * 32
    assert st.bytes_accessed == 4 * (8 * 16 + 16 * 32 + 8 * 32)
    # an in-place op reads and writes its tensor
    acc = torch.zeros(4, 8)
    st = op_analysis.analyze_callable(
        lambda t: t.add_(1.0), acc)
    assert (st.flops, st.bytes_accessed) == (0.0, 2 * 4 * 4 * 8)


def test_op_counts_of_a_view_are_zero():
    a = torch.ones(8, 16)
    for fn in (lambda x: x.t(), lambda x: x[2:5], lambda x: x.view(16, 8),
               lambda x: x.unsqueeze(0)):
        assert op_analysis.analyze_callable(fn, a) == (0.0, 0.0)


def test_op_count_plan_is_deterministic():
    jg, tg = graphs("two_components")
    w = family_weights(jg)
    p1 = tat.build_plan(tg, weights=w)
    p2 = tat.build_plan(tg, weights=w)
    assert p1 == p2 and p1.checksum() == p2.checksum()
    assert p1.source == "ops"
    assert all(c > 0 and np.isfinite(c) for _, _, c in p1.unit_costs)
    # the JAX package reads an op-count plan too
    assert jat.TuningPlan.from_dict(p1.to_dict()).to_dict() == p1.to_dict()
    for semiring in tat.FORM_VOCAB:
        assert p1.covers(semiring), semiring
    # without weights the tropical forms keep the static costs
    p3 = tat.build_plan(tg)
    static = tat.build_plan(tg, use_hlo=False)
    for form in tat.FORM_VOCAB["tropical"]:
        assert p3.unit_cost("tropical", form) == \
            static.unit_cost("tropical", form)


def test_roofline_terms_match_jax():
    rng = np.random.default_rng(11)
    for _ in range(20):
        flops, nbytes, wire = (float(x) for x in rng.uniform(0, 1e12, 3))
        peak, bw, link = (float(x) for x in rng.uniform(1e9, 1e15, 3))
        kw = dict(peak_flops=peak, hbm_bw=bw, ici_bw=link)
        assert troof.roofline_terms(flops, nbytes, wire, **kw) == \
            jroof.roofline_terms(flops, nbytes, wire, **kw)
