"""The port's checkpoint format (``repro_torch/train/checkpoint.py``)
against the JAX package's: one tree saved by both gives equal
``MANIFEST.json`` files and equal ``.bin`` bytes, and each package
restores what the other wrote; round trips of nested trees of tensors
and numpy (bfloat16 included), the sha256 check, the stale-``.tmp``
purge, ``keep`` GC, the ``join`` / ``skip`` policies and the async
snapshot."""
import collections
import filecmp
import os
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as J
from repro_torch.train import checkpoint as C

Pair = collections.namedtuple("Pair", "dist sigma")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _trees():
    """The same tree in both packages' leaf types: dicts (keys out of
    order), lists, tuples, a NamedTuple, None, scalars and arrays of
    several dtypes."""
    rng = np.random.default_rng(0)
    dist = rng.integers(-1, 9, (3, 5)).astype(np.int32)
    sigma = rng.random((3, 5)).astype(np.float32)
    w = (np.arange(8, dtype=np.float32) / 4).reshape(2, 4)
    j = {"zeta": np.float32(2.5), "state": Pair(jnp.asarray(dist),
                                                 jnp.asarray(sigma)),
         "alpha": [jnp.asarray(w, jnp.bfloat16), (np.int32(7), None)],
         "mask": np.array([True, False, True]),
         "count": np.int64(11), "empty": {}}
    t = {"zeta": np.float32(2.5), "state": Pair(torch.from_numpy(dist),
                                                 torch.from_numpy(sigma)),
         "alpha": [torch.from_numpy(w).to(torch.bfloat16),
                   (np.int32(7), None)],
         "mask": torch.tensor([True, False, True]),
         "count": np.int64(11), "empty": {}}
    return j, t


def test_same_manifest_and_bytes_as_jax():
    jtree, ttree = _trees()
    meta = {"job": "sweep-v1", "chunks_total": 4, "mode": "sparse"}
    with tempfile.TemporaryDirectory() as d:
        jd, td = os.path.join(d, "jax"), os.path.join(d, "torch")
        J.save(jd, 3, jtree, meta=meta)
        C.save(td, 3, ttree, meta=meta)
        sj, st = (os.path.join(x, "step_000000003") for x in (jd, td))
        assert sorted(os.listdir(sj)) == sorted(os.listdir(st))
        for f in os.listdir(sj):
            assert filecmp.cmp(os.path.join(sj, f), os.path.join(st, f),
                               shallow=False), f
        man = C.read_manifest(td, 3)
        assert list(man["leaves"]) == [
            "['alpha'][0]", "['alpha'][1][0]", "['count']", "['mask']",
            "['state'].dist", "['state'].sigma", "['zeta']"]
        assert man["leaves"]["['alpha'][0]"]["dtype"] == "bfloat16"
        assert man["meta"] == meta


def test_each_package_restores_what_the_other_wrote():
    jtree, ttree = _trees()
    with tempfile.TemporaryDirectory() as d:
        J.save(d, 1, jtree)
        got, step = C.restore(d, 1, ttree)
        assert step == 1
        assert isinstance(got["state"], Pair)
        np.testing.assert_array_equal(got["state"].dist,
                                      np.asarray(jtree["state"].dist))
        assert got["alpha"][0].dtype == torch.bfloat16   # numpy has none
        assert torch.equal(got["alpha"][0], ttree["alpha"][0])
        assert got["alpha"][1][1] is None and got["empty"] == {}
        assert got["mask"].dtype == np.bool_
        C.save(d, 2, ttree)
        # (JAX's restore puts the leaves on its device, which narrows
        # int64 to int32 without x64: values are compared)
        back, _ = J.restore(d, 2, jtree)
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(jtree)):
            np.testing.assert_array_equal(np.asarray(a, np.float32),
                                          np.asarray(b, np.float32))


def test_roundtrip_nested_tree_host_and_device():
    _, tree = _trees()
    with tempfile.TemporaryDirectory() as d:
        C.save(d, 5, tree)
        host, _ = C.restore(d, 5, tree)
        assert isinstance(host["state"].sigma, np.ndarray)
        np.testing.assert_array_equal(host["state"].sigma,
                                      tree["state"].sigma.numpy())
        assert host["zeta"].shape == () and host["zeta"] == 2.5
        assert list(host) == sorted(tree)            # keys sorted, as JAX
        dev, _ = C.restore(d, 5, tree, device="cpu")
        assert isinstance(dev["state"].dist, torch.Tensor)
        assert torch.equal(dev["state"].dist, tree["state"].dist)
        assert torch.equal(dev["alpha"][0], tree["alpha"][0])
        assert dev["count"].dtype == torch.int64
        # shardings= is a tree of meshes matching the tree (restored onto
        # a CPU mesh in tests/test_torch_distributed.py)
        with pytest.raises(ValueError, match="shardings for"):
            C.restore(d, 5, tree, shardings=object())
        foreign = C._rebuild(tree, iter([object()] * len(C._leaf_paths(
            tree))))
        with pytest.raises(ValueError, match="DeviceMesh"):
            C.restore(d, 5, tree, shardings=foreign)
        with pytest.raises(ValueError, match="not both"):
            C.restore(d, 5, tree, shardings=foreign, device="cpu")


def test_restore_detects_corruption_and_missing_leaves():
    with tempfile.TemporaryDirectory() as d:
        tree = {"a": torch.ones(4)}
        C.save(d, 1, tree)
        with open(os.path.join(d, "step_000000001", "0000.bin"),
                  "r+b") as f:
            f.write(b"\xde\xad")
        with pytest.raises(IOError, match="corruption"):
            C.restore(d, 1, tree)
        restored, _ = C.restore(d, 1, tree, verify=False)   # bytes as-is
        assert restored["a"].shape == (4,)
        with pytest.raises(KeyError):
            C.restore(d, 1, {"b": torch.ones(4)})


def test_stale_tmp_is_purged_and_never_listed():
    with tempfile.TemporaryDirectory() as d:
        stale = os.path.join(d, "step_000000005.tmp")
        os.makedirs(stale)
        with open(os.path.join(stale, "9999.bin"), "wb") as f:
            f.write(b"leftover from a crashed writer")
        C.save(d, 5, {"a": torch.arange(4)})
        final = os.path.join(d, "step_000000005")
        assert sorted(os.listdir(final)) == ["0000.bin", "MANIFEST.json"]
        tmp = os.path.join(d, "step_000000009.tmp")
        os.makedirs(tmp)
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            f.write("{}")
        assert C.all_steps(d) == [5] and C.latest_step(d) == 5
        restored, _ = C.restore(d, 5, {"a": torch.arange(4)})
        np.testing.assert_array_equal(restored["a"], np.arange(4))
    assert C.latest_step(os.path.join(d, "gone")) is None


@pytest.mark.parametrize("keep", [1, 2, 3])
def test_keep_gc_retains_newest(keep):
    with tempfile.TemporaryDirectory() as d:
        for s in range(1, 6):
            C.save(d, s, {"a": np.int32(s)}, keep=keep)
        assert C.all_steps(d) == list(range(6 - keep, 6))
        assert C.restore(d, 5, {"a": 0})[0]["a"] == 5


def test_manifest_meta_roundtrip():
    meta = {"workload": "boolean", "edges_sha": "abc123", "chunks": 7}
    with tempfile.TemporaryDirectory() as d:
        C.save(d, 2, {"a": torch.ones(3)}, meta=meta)
        assert C.read_manifest(d, 2)["meta"] == meta
        C.save(d, 4, {"a": torch.ones(3)})
        assert "meta" not in C.read_manifest(d, 4)


@pytest.mark.parametrize("kind", ["numpy", "tensor", "bfloat16"])
def test_async_save_snapshots_before_returning(kind):
    """save(blocking=False) copies a host leaf before the writer thread
    starts: overwriting the buffer right after submit may not tear the
    checkpoint (``.numpy()`` and ``np.asarray`` are views)."""
    want = np.arange(4096, dtype=np.int32) % 256      # exact in bfloat16
    if kind == "numpy":
        leaf = want.copy()
    elif kind == "tensor":
        leaf = torch.from_numpy(want.copy())
    else:
        leaf = torch.from_numpy(want.astype(np.float32)).to(torch.bfloat16)
    with tempfile.TemporaryDirectory() as d:
        t = C.save(d, 1, {"a": leaf}, blocking=False)
        leaf[:] = -1                     # the caller reuses its buffer
        t.join()
        restored, _ = C.restore(d, 1, {"a": leaf})
        got = restored["a"]
        if kind == "bfloat16":
            assert got.dtype == torch.bfloat16
            got = got.to(torch.float32).numpy()
        np.testing.assert_array_equal(np.asarray(got, np.float64),
                                      want.astype(np.float64))


def test_checkpoint_hook_join_and_skip_policies(monkeypatch):
    release = threading.Event()
    joined = []

    def fake_save(ckpt_dir, step, tree, *, blocking=True, keep=3,
                  meta=None):
        t = threading.Thread(target=release.wait, daemon=True)
        orig_join = t.join

        def join(*a):
            joined.append(step)
            release.set()
            orig_join(*a)
        t.join = join
        t.start()
        return t

    monkeypatch.setattr(C, "save", fake_save)
    hook = C.CheckpointHook("/nonexistent", keep=2, policy="skip")
    assert hook.submit(1, {}) is True
    assert hook.submit(2, {}) is False       # first write still in flight
    assert hook.skipped == 1 and hook.written == 1
    assert hook.pending is not None and hook.pending.is_alive()
    hook.flush()
    assert hook.pending is None

    release.clear()
    joined.clear()
    hook = C.CheckpointHook("/nonexistent", keep=2)   # policy="join"
    hook.submit(1, {})
    hook.submit(2, {})                       # must join write 1 first
    assert joined == [1]
    assert hook.written == 2 and hook.skipped == 0
    hook.flush()
    with pytest.raises(ValueError):
        C.CheckpointHook("/x", policy="overlap")


def test_checkpoint_hook_writes_every_interval():
    with tempfile.TemporaryDirectory() as d:
        hook = C.CheckpointHook(d, interval=2, keep=5)
        for step in range(6):
            hook(step, {"w": torch.full((2,), float(step))},
                 {"m": np.int32(step)}, None)
        hook.flush()
        assert C.all_steps(d) == [2, 4, 6] and hook.written == 3
        tree, _ = C.restore(d, 6, {"params": {"w": 0}, "opt": {"m": 0}})
        np.testing.assert_array_equal(tree["params"]["w"], [5.0, 5.0])
        assert tree["opt"]["m"] == 5
