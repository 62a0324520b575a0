"""The port's ``CheckpointManager`` (``gofr_tpu_torch/checkpoint``) and
``ServingEngine.from_checkpoint`` beside the JAX package's, npz backend:
round trip, monotonic steps, prune, an uncommitted step invisible, a
corrupt manifest, structure, shape and dtype mismatches, bf16, health,
training resume, the engine's warm restart; and across packages, a step
saved by either restored by the other bit for bit (f32 and bf16). The
reference's ``backend="auto"`` means orbax where orbax imports (it does
here), so its side passes ``backend="npz"``. Equality is bit for bit
throughout; the resume compares losses at rtol 1e-6 (f32, CPU)."""

from __future__ import annotations

import json
import os
import types
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from gofr_tpu.checkpoint import CheckpointError as JCheckpointError  # noqa: E402
from gofr_tpu.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from gofr_tpu.models import llama as jllama  # noqa: E402
from gofr_tpu_torch import tree as tree_util  # noqa: E402
from gofr_tpu_torch.checkpoint import CheckpointError, CheckpointManager  # noqa: E402
from gofr_tpu_torch.models import llama as tllama  # noqa: E402
from gofr_tpu_torch.models import train  # noqa: E402
from gofr_tpu_torch.models.convert import params_from_jax  # noqa: E402

SIDES = {"ref": (JCheckpointManager, JCheckpointError), "port": (CheckpointManager,
                                                                 CheckpointError)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trees():
    """The tiny Llama params on each side (the port's carried from JAX)."""
    jparams = jllama.init_params(jllama.LlamaConfig.tiny(), jax.random.PRNGKey(0))
    return {"ref": jparams, "port": params_from_jax(jax.device_get(jparams), device="cpu")}


def _bits(x) -> np.ndarray:
    """A leaf's raw bytes, whichever package holds it."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        return (t.view(torch.uint16) if t.dtype == torch.bfloat16 else t).numpy().view(np.uint8)
    arr = np.asarray(x)
    return np.ascontiguousarray(arr).view(np.uint8)


def _dtype(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def assert_bit_equal(a, b):
    la, lb = tree_util.leaves(a), jax.tree.leaves(b) if not _is_port(b) else tree_util.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert tuple(x.shape) == tuple(y.shape) and _dtype(x) == _dtype(y)
        np.testing.assert_array_equal(_bits(x), _bits(y))


def _is_port(tree) -> bool:
    return isinstance(tree_util.leaves(tree)[0], torch.Tensor)


def _mgr(side: str, path, **kw):
    cls = SIDES[side][0]
    if side == "ref":
        kw.setdefault("backend", "npz")
    return cls(str(path), **kw)


def _restore(side: str, mgr, abstract, **kw):
    return mgr.restore(abstract, device="cpu", **kw) if side == "port" else mgr.restore(abstract, **kw)


def _plus_one(side: str, tree):
    if side == "port":
        return tree_util.tree_map(lambda t: t + 1, tree)
    return jax.tree.map(lambda x: x + 1, tree)


@pytest.mark.parametrize("side", ["ref", "port"])
def test_save_restore_roundtrip(tmp_path, trees, side):
    params = trees[side]
    mgr = _mgr(side, tmp_path)
    mgr.save(1, params, metadata={"loss": 3.2})
    assert_bit_equal(_restore(side, mgr, params), params)
    assert mgr.metadata(1) == {"loss": 3.2}
    assert json.load(open(tmp_path / "MANIFEST.json"))["steps"][0]["backend"] == "npz"


def test_resume_latest_and_monotonic_match_the_reference(tmp_path, trees):
    got = {}
    for side in SIDES:
        err = SIDES[side][1]
        params = trees[side]
        mgr = _mgr(side, tmp_path / side)
        p2 = _plus_one(side, params)
        mgr.save(10, params)
        mgr.save(20, p2)
        assert_bit_equal(_restore(side, mgr, params), p2)  # newest wins
        assert_bit_equal(_restore(side, mgr, params, step=10), params)
        messages = []
        for bad in (20, 15):
            with pytest.raises(err, match="not past") as exc:
                mgr.save(bad, params)  # a rewind is refused
            messages.append(str(exc.value))
        got[side] = (mgr.latest_step(), mgr.all_steps(), messages)
    assert got["port"] == got["ref"]


def test_prune_keeps_newest_as_the_reference_does(tmp_path, trees):
    got = {}
    for side in SIDES:
        params = trees[side]
        mgr = _mgr(side, tmp_path / side, keep=2)
        for step in (1, 2, 3, 4):
            mgr.save(step, params)
        with pytest.raises(SIDES[side][1]) as exc:
            _restore(side, mgr, params, step=1)
        got[side] = (mgr.all_steps(), os.path.exists(mgr._step_dir(1)),
                     sorted(os.listdir(tmp_path / side)), str(exc.value))
    assert got["port"] == got["ref"]
    assert got["port"][0] == [3, 4]


def test_uncommitted_step_invisible(tmp_path, trees):
    got = {}
    for side in SIDES:
        params = trees[side]
        mgr = _mgr(side, tmp_path / side)
        mgr.save(1, params)
        os.makedirs(mgr._step_dir(2), exist_ok=True)  # a crash before the commit
        (tmp_path / side / "step_000000002" / "weights.npz").write_bytes(b"torn")
        latest = mgr.latest_step()
        with pytest.raises(SIDES[side][1], match="not committed"):
            _restore(side, mgr, params, step=2)
        mgr.save(2, params)  # the debris is cleared and the step commits
        assert_bit_equal(_restore(side, mgr, params, step=2), params)
        got[side] = (latest, mgr.latest_step())
    assert got["port"] == got["ref"] == (1, 2)


def test_corrupt_manifest_surfaces(tmp_path, trees):
    got = {}
    for side in SIDES:
        mgr = _mgr(side, tmp_path / side)
        mgr.save(1, trees[side])
        (tmp_path / side / "MANIFEST.json").write_text("{not json")
        with pytest.raises(SIDES[side][1], match="corrupt manifest"):
            mgr.latest_step()
        health = mgr.health_check()
        got[side] = (health["status"], health["details"]["error"].split(" at ")[0])
    assert got["port"] == got["ref"] == ("DEGRADED", "corrupt manifest")


def test_structure_mismatch_rejected(tmp_path):
    """The same leaf count and shapes under another nesting is refused on
    both sides with the same structure strings."""
    got = {}
    trees_ = {
        "ref": ({"x": jnp.zeros((4, 4)), "y": jnp.ones((4, 4))},
                {"p": {"x": jnp.zeros((4, 4))}, "q": jnp.ones((4, 4))}),
        "port": ({"x": torch.zeros(4, 4), "y": torch.ones(4, 4)},
                 {"p": {"x": torch.zeros(4, 4)}, "q": torch.ones(4, 4)}),
    }
    for side, (a, b) in trees_.items():
        mgr = _mgr(side, tmp_path / side)
        mgr.save(1, a)
        with pytest.raises(SIDES[side][1], match="structure mismatch") as exc:
            _restore(side, mgr, b)
        got[side] = str(exc.value)
    assert got["port"] == got["ref"]


def test_shape_mismatch_rejected(tmp_path, trees):
    got = {}
    jother = jllama.init_params(jllama.LlamaConfig.tiny(d_model=128, n_heads=8),
                                jax.random.PRNGKey(1))
    others = {"ref": jother, "port": params_from_jax(jax.device_get(jother), device="cpu")}
    for side in SIDES:
        mgr = _mgr(side, tmp_path / side)
        mgr.save(1, trees[side])
        with pytest.raises(SIDES[side][1], match="mismatch") as exc:
            _restore(side, mgr, others[side])
        got[side] = str(exc.value)
    assert got["port"] == got["ref"]


def test_dtype_mismatch_rejected(tmp_path):
    got = {}
    pairs = {"ref": ({"w": jnp.ones((2, 2), jnp.float32)}, {"w": jnp.ones((2, 2), jnp.bfloat16)}),
             "port": ({"w": torch.ones(2, 2)}, {"w": torch.ones(2, 2, dtype=torch.bfloat16)})}
    for side, (saved, wrong) in pairs.items():
        mgr = _mgr(side, tmp_path / side)
        mgr.save(1, saved)
        with pytest.raises(SIDES[side][1], match="dtype mismatch") as exc:
            _restore(side, mgr, wrong)
        got[side] = str(exc.value)
    assert got["port"] == got["ref"]


def test_bfloat16_roundtrip_and_layout(tmp_path):
    """bf16 leaves are stored as uint16 words under "bfloat16" in
    tree.json, and come back as bf16 bit for bit (NaN, -0.0, subnormals)."""
    w = torch.tensor([1.5, -0.0, float("nan"), 1e-40, -3e38]).to(torch.bfloat16)
    tree = {"w": w, "b": torch.arange(4, dtype=torch.float32)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    meta = json.load(open(tmp_path / "step_000000001" / "tree.json"))
    assert meta["dtypes"] == ["float32", "bfloat16"] and meta["n_leaves"] == 2
    with np.load(tmp_path / "step_000000001" / "weights.npz") as data:
        assert data["leaf_1"].dtype == np.uint16
    restored = mgr.restore(tree, device="cpu")
    assert restored["w"].dtype == torch.bfloat16
    assert_bit_equal(restored, tree)


def test_health_check_matches_the_reference(tmp_path, trees):
    got = {}
    for side in SIDES:
        mgr = _mgr(side, tmp_path / side)
        before = mgr.health_check()
        mgr.save(5, trees[side])
        after = mgr.health_check()
        for h in (before, after):
            assert h["details"].pop("directory") == str(tmp_path / side)
        got[side] = (before, after)
    assert got["port"] == got["ref"]
    assert got["port"][1]["details"]["latest"] == 5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_reference_save_restores_in_the_port_bit_for_bit(tmp_path, dtype):
    cfg = jllama.LlamaConfig.tiny(dtype=getattr(jnp, dtype))
    jparams = jllama.init_params(cfg, jax.random.PRNGKey(2))
    jmgr = JCheckpointManager(str(tmp_path), backend="npz")
    jmgr.save(3, jparams, metadata={"from": "jax"})
    tcfg = tllama.LlamaConfig.tiny(dtype=getattr(torch, dtype))
    abstract = tllama.init_params(tcfg, device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 3 and mgr.metadata(3) == {"from": "jax"}
    restored = mgr.restore(abstract, device="cpu")
    assert_bit_equal(restored, jax.device_get(jparams))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_port_save_restores_in_the_reference_bit_for_bit(tmp_path, dtype):
    tcfg = tllama.LlamaConfig.tiny(dtype=getattr(torch, dtype))
    params = tllama.init_params(tcfg, torch.Generator().manual_seed(5), device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, params, metadata={"from": "torch"})
    cfg = jllama.LlamaConfig.tiny(dtype=getattr(jnp, dtype))
    abstract = jax.eval_shape(lambda: jllama.init_params(cfg, jax.random.PRNGKey(0)))
    jmgr = JCheckpointManager(str(tmp_path), backend="npz")
    assert jmgr.all_steps() == [4] and jmgr.metadata(4) == {"from": "torch"}
    restored = jmgr.restore(abstract)
    assert_bit_equal(params, restored)


def test_orbax_is_refused(tmp_path, trees):
    """The port has no orbax backend: asking for it is refused, and a step
    the reference wrote with orbax raises naming it."""
    pytest.importorskip("orbax.checkpoint")
    with pytest.raises(ValueError, match="npz only"):
        CheckpointManager(str(tmp_path / "x"), backend="orbax")
    JCheckpointManager(str(tmp_path), backend="orbax").save(1, trees["ref"])
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 1 and mgr.backend == "npz"
    with pytest.raises(CheckpointError, match="'orbax' backend"):
        mgr.restore(trees["port"], device="cpu")


def test_restore_refuses_sharding_and_needs_a_device(tmp_path, trees, monkeypatch):
    """``sharding=`` takes placements only (a mesh of ranks restores each
    rank's slices: ``test_torch_parallel.py``); on a one-rank mesh a
    replicated placement and the rules both give the whole tree, bit for
    bit. Without a card, restoring needs ``device="cpu"``."""
    from gofr_tpu_torch.parallel import build_mesh, llama_sharding_rules, named_sharding

    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, trees["port"])
    with pytest.raises(TypeError, match="NamedSharding"):
        mgr.restore(trees["port"], sharding=object(), device="cpu")
    with pytest.raises(TypeError, match="NamedSharding"):
        mgr.restore(trees["port"], sharding=tree_util.tree_map(lambda _: 1, trees["port"]),
                    device="cpu")
    with pytest.raises(ValueError, match="no placement for 'embedding'"):
        mgr.restore(trees["port"], sharding={"layers": {}}, device="cpu")
    mesh = build_mesh()
    for sharding in (named_sharding(mesh), llama_sharding_rules().tree_shardings(mesh, trees["port"])):
        assert_bit_equal(mgr.restore(trees["port"], sharding=sharding, device="cpu"), trees["port"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mgr.restore(trees["port"])


def test_a_sharded_restore_reads_each_slice_alone(tmp_path, trees, monkeypatch):
    """A sharded restore reads a leaf's slice and no more of it: every
    half of every dim of every stored leaf (the port's archive and
    ``np.savez``'s) comes back equal to the array's own slice, and the
    file reads that fetch it add up to the slice's bytes."""
    from gofr_tpu_torch.checkpoint import manager

    read = []
    preadv = os.preadv

    def counted(fd, buffers, offset):
        read.append(preadv(fd, buffers, offset))
        return read[-1]

    monkeypatch.setattr(manager.os, "preadv", counted)
    host = [(t.view(torch.uint16) if t.dtype == torch.bfloat16 else t).numpy()
            for t in tree_util.leaves(trees["port"])]
    CheckpointManager(str(tmp_path / "port")).save(1, trees["port"])
    np.savez(tmp_path / "savez.npz", *host)
    archives = ((str(tmp_path / "port" / "step_000000001" / "weights.npz"), "leaf_{}.npy"),
                (str(tmp_path / "savez.npz"), "arr_{}.npy"))
    cases = 0
    for path, member in archives:
        with zipfile.ZipFile(path) as zf:
            for i, arr in enumerate(host):
                stored = manager._stored_array(path, zf.getinfo(member.format(i)))
                assert stored.shape == arr.shape and stored.dtype == arr.dtype
                for dim, n in enumerate(arr.shape):
                    for half in (slice(0, n // 2), slice(n // 2, n)):
                        index = (slice(None),) * dim + (half,)
                        read.clear()
                        got = stored[index]
                        assert np.array_equal(got, arr[index]), (path, i, index)
                        assert sum(read) == got.nbytes, (path, i, index)
                        cases += 1
    assert cases > 4 * len(host)


def test_save_records_the_histogram_the_reference_registers(tmp_path, trees):
    """``app_checkpoint_save_seconds``: registered by the manager on the
    Manager it is given (as the reference's, with its kind, description
    and buckets, and listed in the catalog's self-registered table), one
    observation a save."""
    from gofr_tpu.metrics import new_metrics_manager as jnew_manager
    from gofr_tpu_torch.metrics import new_metrics_manager
    from gofr_tpu_torch.serving.metrics_catalog import SELF_REGISTERED_METRICS

    jm, tm = jnew_manager(), new_metrics_manager()
    JCheckpointManager(str(tmp_path / "ref"), backend="npz", metrics=jm)
    mgr = CheckpointManager(str(tmp_path / "port"), metrics=tm)
    CheckpointManager(str(tmp_path / "port"), metrics=tm)  # a second one registers nothing
    ref, port = jm.get("app_checkpoint_save_seconds"), tm.get("app_checkpoint_save_seconds")
    assert (type(port).__name__, port.description, port.buckets) == (
        type(ref).__name__, ref.description, ref.buckets)
    assert ("histogram", "app_checkpoint_save_seconds", port.description, None) in \
        SELF_REGISTERED_METRICS
    mgr.save(1, trees["port"])
    mgr.save(2, trees["port"])
    assert "app_checkpoint_save_seconds_count 2" in tm.expose_prometheus()


def test_training_resume_equivalence(tmp_path):
    """4 steps straight against 2 steps, a checkpoint of params and the
    optimizer state, a restore and 2 more: the same final loss (rtol 1e-6)
    and params, as the reference's test holds its own."""
    cfg = tllama.LlamaConfig.tiny()
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(7))
    init_opt, step = train.make_train_step(cfg, train.adamw(1e-3))

    def fresh():
        return tllama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    p = fresh()
    s = init_opt(p)
    for _ in range(4):
        p, s, loss_straight = step(p, s, tokens)
    p2 = fresh()
    s2 = init_opt(p2)
    for _ in range(2):
        p2, s2, _ = step(p2, s2, tokens)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, {"params": p2, "opt": s2})
    restored = mgr.restore({"params": p2, "opt": s2}, device="cpu")
    p3, s3 = restored["params"], restored["opt"]
    assert int(s3["step"]) == 2
    for _ in range(2):
        p3, s3, loss_resumed = step(p3, s3, tokens)
    np.testing.assert_allclose(float(loss_resumed), float(loss_straight), rtol=1e-6)
    assert_bit_equal(p3, p)


def test_engine_warm_restart(tmp_path):
    """``from_checkpoint`` over a step the JAX package saved serves the
    tokens of the reference engine over the same params and of a port
    engine built directly; no step and no seed raises, a seed falls back to
    random weights, a corrupt existing checkpoint raises, ``sharding=``
    takes a replicated placement and refuses the rest."""
    from gofr_tpu.serving import ByteTokenizer as JByteTokenizer
    from gofr_tpu.serving import EngineConfig as JEngineConfig
    from gofr_tpu.serving import ServingEngine as JServingEngine
    from gofr_tpu_torch.parallel import build_mesh, named_sharding
    from gofr_tpu_torch.parallel.sharding import NamedSharding, P
    from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer

    jcfg = jllama.LlamaConfig.tiny(vocab_size=300)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(3))
    JCheckpointManager(str(tmp_path / "ck"), backend="npz").save(7, jparams)
    tcfg = tllama.LlamaConfig.tiny(vocab_size=300)
    conf = dict(max_slots=2, max_seq_len=64, prefill_buckets=(16,))
    ref = JServingEngine(jcfg, jparams, JEngineConfig(**conf), JByteTokenizer())
    warm = ServingEngine.from_checkpoint(tcfg, str(tmp_path / "ck"),
                                         engine_config=EngineConfig(**conf),
                                         tokenizer=ByteTokenizer(), device="cpu")
    direct = ServingEngine(tcfg, params_from_jax(jax.device_get(jparams), device="cpu"),
                           EngineConfig(**conf), ByteTokenizer(), device="cpu")
    engines = (ref, warm, direct)
    try:
        for e in engines:
            e.start()
        ids = [e.submit("warm restart", max_new_tokens=8, temperature=0.0).result(timeout=120)
               .token_ids for e in engines]
    finally:
        for e in engines:
            e.stop()
    assert list(ids[1]) == list(ids[0]) == list(ids[2]) and len(ids[0]) == 8
    with pytest.raises(CheckpointError, match="no committed"):
        ServingEngine.from_checkpoint(tcfg, str(tmp_path / "empty"), device="cpu")
    eng = ServingEngine.from_checkpoint(tcfg, str(tmp_path / "empty"), seed=0,
                                        engine_config=EngineConfig(**conf), device="cpu")
    want = tllama.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert_bit_equal(eng.params, want)
    # the engine's refusal covers a value that is not a placement and a
    # placement that splits the weights (the tensor-parallel engine)
    with pytest.raises(TypeError, match="NamedSharding"):
        ServingEngine.from_checkpoint(tcfg, str(tmp_path / "ck"), sharding=object(),
                                      device="cpu")
    tp2 = NamedSharding(types.SimpleNamespace(shape={"dp": 1, "fsdp": 1, "pp": 1, "sp": 1,
                                                     "ep": 1, "tp": 2}), P(None, "tp"))
    with pytest.raises(NotImplementedError, match="tensor-parallel engine"):
        ServingEngine.from_checkpoint(tcfg, str(tmp_path / "ck"), sharding=tp2, device="cpu")
    replicated = ServingEngine.from_checkpoint(tcfg, str(tmp_path / "ck"), device="cpu",
                                               sharding=named_sharding(build_mesh()))
    assert_bit_equal(replicated.params, direct.params)
    weights = tmp_path / "ck" / "step_000000007" / "weights.npz"
    weights.write_bytes(weights.read_bytes()[:100])  # a torn file under a committed step
    with pytest.raises(zipfile.BadZipFile):  # propagates, as the reference's does
        ServingEngine.from_checkpoint(tcfg, str(tmp_path / "ck"), seed=0, device="cpu")
