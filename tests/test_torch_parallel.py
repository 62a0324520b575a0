"""The port's mesh, sharding rules, tensor-parallel forward, sharded
restores and sharded training step against the JAX package
(``tests/test_parallel.py``, ``test_checkpoint.py::test_restore_onto_mesh_sharding``,
``test_hf_import.py::test_sharded_load_places_on_mesh``).

One gloo world of 8 ranks on the CPU runs every case once
(``torch_parallel_cases.parallel_world``); the JAX side runs here on the
8-device CPU mesh of ``conftest.py``, rank r of the port standing where
device r stands on the reference's mesh. Tolerance: rtol=atol=2e-4 at tiny
f32, the reference's own for the sharded forward. ``run_spmd`` and
``init_parallel`` have their own tests at the end.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JNamedSharding, PartitionSpec as JP

import torch_parallel_cases as cases
from gofr_tpu.checkpoint import CheckpointManager as JCheckpointManager
from gofr_tpu.models import llama as jllama
from gofr_tpu.models.hf_import import load_llama_from_hf as jload_hf
from gofr_tpu.models.train import sharded_train_step as jsharded_train_step
from gofr_tpu.parallel import MeshSpec as JMeshSpec, build_mesh as jbuild_mesh
from gofr_tpu.parallel import llama_sharding_rules as jrules, shard_params as jshard_params
from gofr_tpu.parallel.mesh import require_axis as jrequire_axis
from gofr_tpu.parallel.sharding import ShardingRules as JShardingRules
from gofr_tpu_torch.parallel import MeshSpec, build_mesh, llama_sharding_rules
from gofr_tpu_torch.parallel import world
from gofr_tpu_torch.parallel.mesh import require_axis
from gofr_tpu_torch.parallel.sharding import P, ShardingRules, map_with_path

TOL = 2e-4
FORWARD_CASES = [  # (case, mesh, tokens, tied)
    ("tp=4,dp=2", "tp=4,dp=2", "tokens2", False),
    ("fsdp=2,tp=2,dp=2", "fsdp=2,tp=2,dp=2", "tokens4", False),
    ("tp=2,dp=4", "tp=2,dp=4", "tokens4", False),
    ("tp=4,dp=2 tied", "tp=4,dp=2", "tokens2", True),
]


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _hf_tensors(params: dict) -> dict:
    """The tiny params in HF's LlamaForCausalLM layout ([out, in] weights)."""
    names = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
             "wo": "self_attn.o_proj", "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
             "w_down": "mlp.down_proj"}
    out = {"model.embed_tokens.weight": params["embedding"],
           "model.norm.weight": params["final_norm"],
           "lm_head.weight": params["lm_head"].T}
    layers = params["layers"]
    for i in range(layers["wq"].shape[0]):
        for key, name in names.items():
            out[f"model.layers.{i}.{name}.weight"] = layers[key][i].T
        out[f"model.layers.{i}.input_layernorm.weight"] = layers["attn_norm"][i]
        out[f"model.layers.{i}.post_attention_layernorm.weight"] = layers["mlp_norm"][i]
    return {k: np.ascontiguousarray(v, dtype=np.float32) for k, v in out.items()}


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    from safetensors.numpy import save_file

    root = tmp_path_factory.mktemp("parallel")
    cfg = jllama.LlamaConfig.tiny()
    params = _np(jllama.init_params(cfg, jax.random.PRNGKey(0)))
    tied = _np(jllama.init_params(jllama.LlamaConfig.tiny(tie_embeddings=True),
                                  jax.random.PRNGKey(2)))
    # the reference writes the checkpoint the port's ranks restore
    JCheckpointManager(str(root / "ckpt"), backend="npz").save(1, params)
    hf = root / "hf"
    hf.mkdir()
    save_file(_hf_tensors(params), str(hf / "model.safetensors"))
    (hf / "config.json").write_text(json.dumps({
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.d_model,
        "num_hidden_layers": cfg.n_layers, "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads, "intermediate_size": cfg.d_ff,
        "max_position_embeddings": cfg.max_seq_len, "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.norm_eps, "tie_word_embeddings": False,
    }))
    rng = np.random.default_rng(1)
    inp = {
        "params": params, "params_tied": tied, "ckpt": str(root / "ckpt"), "hf": str(hf),
        "tokens2": rng.integers(0, cfg.vocab_size, (2, 8)),
        "tokens4": rng.integers(0, cfg.vocab_size, (4, 8)),
        "train_tokens": rng.integers(0, cfg.vocab_size, (8, 16)),
        "forward_cases": [(c, s, k, t) for c, s, k, t in FORWARD_CASES],
    }
    results = world.run_spmd(cases.parallel_world, 8, args=(inp,), backend="gloo",
                             device="cpu", timeout_s=240)
    return inp, results


def _index(jmesh, spec, shape, rank: int):
    """The slice the reference's sharding gives device ``rank``."""
    device = jmesh.devices.flat[rank]
    return JNamedSharding(jmesh, spec).devices_indices_map(tuple(shape))[device]


def _hold_slices(local_tree, full_tree, jmesh, rules, rank: int, exact: bool, atol=TOL):
    """Every leaf of ``local_tree`` is rank's slice of ``full_tree`` by the
    reference's rules on ``jmesh``."""
    specs = rules.tree_specs(full_tree)
    for path, want in jax.tree_util.tree_flatten_with_path(full_tree)[0]:
        keys = [k.key for k in path]
        got, spec = local_tree, specs
        for k in keys:
            got, spec = got[k], spec[k]
        want = np.asarray(want)[_index(jmesh, spec, want.shape, rank)]
        if exact:
            np.testing.assert_array_equal(got, want, err_msg=f"rank {rank} {'/'.join(keys)}")
        else:
            np.testing.assert_allclose(got, want, rtol=TOL, atol=atol,
                                       err_msg=f"rank {rank} {'/'.join(keys)}")


def test_mesh_spec_parse():
    for text in ("dp=2,tp=4", "", " pp = 2 , tp=2 ", "dp=-1,tp=4"):
        assert MeshSpec.parse(text).sizes() == JMeshSpec.parse(text).sizes()
    spec = MeshSpec.parse("dp=2,tp=4")
    assert spec.dp == 2 and spec.tp == 4 and spec.pp == 1
    for bad in ("bogus=2", "tp=x", "tp"):
        with pytest.raises(ValueError) as port:
            MeshSpec.parse(bad)
        with pytest.raises(ValueError) as ref:
            JMeshSpec.parse(bad)
        assert str(port.value) == str(ref.value)


def test_mesh_wildcard_resolution():
    spec = MeshSpec.parse("dp=-1,tp=4").resolve(8)
    assert spec.dp == 2 and spec.tp == 4
    for text, n in (("dp=3,tp=4", 8), ("dp=-1,tp=-1", 8), ("dp=-1,tp=3", 8), ("tp=4", 8)):
        with pytest.raises(ValueError) as port:
            MeshSpec.parse(text).resolve(n)
        with pytest.raises(ValueError) as ref:
            JMeshSpec.parse(text).resolve(n)
        assert str(port.value) == str(ref.value)
    assert MeshSpec.parse("tp=2").total() == JMeshSpec.parse("tp=2").total()


def test_build_mesh_8_devices(world8):
    _, results = world8
    for spec in ("dp=2,tp=4", "tp=4,dp=2", "fsdp=2,tp=2,dp=2", "tp=2,dp=4"):
        jmesh = jbuild_mesh(spec)
        for rank, res in enumerate(results):
            shape, devices_shape, coordinate = res["mesh"][spec]
            assert shape == dict(jmesh.shape) and devices_shape == jmesh.devices.shape
            where = np.argwhere(jmesh.devices == jax.devices()[rank])[0]
            assert coordinate == dict(zip(jmesh.axis_names, (int(c) for c in where)))
    one = build_mesh()  # no process group: a mesh of one rank
    assert one.shape == dict(jbuild_mesh(JMeshSpec(dp=1), jax.devices()[:1]).shape)


def test_require_axis_validates_vocabulary(world8):
    _, results = world8
    jmesh = jbuild_mesh("dp=2,tp=4")
    with pytest.raises(ValueError, match="vocabulary") as ref:
        jrequire_axis(jmesh, "model")  # HF-style name, not framework vocab
    for res in results:
        assert res["require_axis"] == (jrequire_axis(jmesh, "tp"), str(ref.value))
    with pytest.raises(ValueError, match="vocabulary"):
        require_axis(build_mesh(), "model")


def test_sharding_rules_reject_unknown_axis():
    with pytest.raises(ValueError, match="unknown mesh axis") as port:
        ShardingRules([(r"w[qkv]$", P("model", None))])
    with pytest.raises(ValueError) as ref:
        JShardingRules([(r"w[qkv]$", JP("model", None))])
    assert str(port.value) == str(ref.value)
    # vocabulary (incl. tuple groups) constructs fine
    ShardingRules([(r"w[qkv]$", P(("dp", "fsdp"), "tp"))])
    tree = _np(jllama.init_params(jllama.LlamaConfig.tiny(), jax.random.PRNGKey(0)))
    for pp in (False, True):
        ref_specs = jrules(pp=pp).tree_specs(tree)
        port_specs = llama_sharding_rules(pp=pp).tree_specs(tree)
        assert jax.tree.leaves(ref_specs, is_leaf=lambda x: isinstance(x, JP)) == \
            [tuple(s) for s in jax.tree.leaves(port_specs, is_leaf=lambda x: isinstance(x, tuple))]


def test_llama_params_shard_onto_mesh(world8):
    inp, results = world8
    jmesh = jbuild_mesh("tp=4,dp=2")
    sharded = jshard_params(inp["params"], jmesh, jrules())
    wq = sharded["layers"]["wq"]
    assert wq.sharding.spec == JP(None, "fsdp", "tp")
    for rank, res in enumerate(results):
        local = res["shards"]
        assert local["layers"]["wq"].shape == wq.sharding.shard_shape(wq.shape)
        assert local["layers"]["wq"].shape[-1] == wq.shape[-1] // 4
        assert local["layers"]["attn_norm"].shape == inp["params"]["layers"]["attn_norm"].shape
        device = jmesh.devices.flat[rank]
        for path in (("layers", "wq"), ("layers", "wo"), ("embedding",), ("lm_head",)):
            arr = sharded
            got = local
            for k in path:
                arr, got = arr[k], got[k]
            shard = next(s for s in arr.addressable_shards if s.device == device)
            np.testing.assert_array_equal(got, np.asarray(shard.data))


@pytest.mark.parametrize("case", [c[0] for c in FORWARD_CASES])
def test_sharded_forward_matches_unsharded(world8, case):
    """The port's tensor-parallel forward (explicit collectives) against
    the reference's sharded forward (compiler-inserted) and unsharded."""
    inp, results = world8
    _, spec, key, tied = next(c for c in FORWARD_CASES if c[0] == case)
    cfg = jllama.LlamaConfig.tiny(tie_embeddings=tied)
    params = inp["params_tied"] if tied else inp["params"]
    tokens = jnp.asarray(inp[key])
    expected = np.asarray(jllama.forward(cfg, params, tokens))
    jmesh = jbuild_mesh(spec)
    sharded = jshard_params(params, jmesh, jrules())
    tokens_sharded = jax.device_put(tokens, JNamedSharding(jmesh, JP(("dp", "fsdp"), None)))
    ref = np.asarray(jllama.forward(cfg, sharded, tokens_sharded))
    np.testing.assert_allclose(ref, expected, rtol=TOL, atol=TOL)
    for res in results:
        np.testing.assert_allclose(res["forward"][case], ref, rtol=TOL, atol=TOL)


def test_restore_onto_mesh_sharding(world8):
    """Each rank restores its slices of the reference's npz checkpoint by
    the rules, bit for bit; the replicated placement restores the whole
    tree."""
    inp, results = world8
    jmesh = jbuild_mesh(JMeshSpec(tp=2, dp=4), jax.devices()[:8])
    mgr = JCheckpointManager(inp["ckpt"], backend="npz")
    restored = mgr.restore(inp["params"], sharding=jrules().tree_shardings(jmesh, inp["params"]))
    assert restored["layers"]["wq"].sharding.spec != JP()
    for rank, res in enumerate(results):
        _hold_slices(res["restore"]["rules"], inp["params"], jmesh, jrules(), rank, exact=True)
        assert res["restore"]["rules"]["layers"]["wq"].shape[-1] == \
            inp["params"]["layers"]["wq"].shape[-1] // 2
        jax.tree.map(np.testing.assert_array_equal, res["restore"]["replicated"],
                     _np(restored))


def test_sharded_load_places_on_mesh(world8):
    """``load_llama_from_hf(sharding=)``: the replicated placement loads
    what the reference's loader loads; the rules keep each rank's slice."""
    inp, results = world8
    jmesh = jbuild_mesh("tp=2,dp=4")
    repl = JNamedSharding(jmesh, JP())
    _, jparams = jload_hf(inp["hf"], dtype=jnp.float32, sharding=repl)
    assert jparams["layers"]["wq"].sharding == repl
    for rank, res in enumerate(results):
        jax.tree.map(np.testing.assert_array_equal, res["hf"]["replicated"], _np(jparams))
        _hold_slices(res["hf"]["rules"], _np(jparams), jmesh, jrules(), rank, exact=True)


@pytest.mark.parametrize("spec", ["tp=2,dp=4", "fsdp=2,tp=2,dp=2"])
def test_sharded_train_step_matches_reference(world8, spec):
    """Three steps of ``sharded_train_step``: the losses and each rank's
    updated slices against the reference's jitted, sharded steps."""
    inp, results = world8
    cfg = jllama.LlamaConfig.tiny()
    jmesh = jbuild_mesh(spec)
    params = jshard_params(inp["params"], jmesh, jrules())
    tokens = jnp.asarray(inp["train_tokens"])
    init, compile_for = jsharded_train_step(cfg, jmesh, jrules())
    opt = init(params)
    step = compile_for(params, opt, tokens)
    losses = []
    for _ in range(3):
        params, opt, loss = step(params, opt, tokens)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    final = _np(params)
    for rank, res in enumerate(results):
        got = res["train"][spec]
        np.testing.assert_allclose(got["losses"], losses, rtol=TOL, atol=TOL)
        _hold_slices(got["params"], final, jmesh, jrules(), rank, exact=False)


def test_sampling_ops():
    """The reference's sampling cases in the same file, on the port's
    ``sample_logits``."""
    from gofr_tpu.ops.sampling import sample_logits as jsample
    from gofr_tpu_torch.ops.sampling import sample_logits

    logits = np.array([[0.0, 10.0, 0.0, 0.0], [10.0, 0.0, 0.0, 0.0]], np.float32)
    gen = torch.Generator().manual_seed(0)
    for kw in ({"temperature": 0.0}, {"temperature": 5.0, "top_k": 1}):
        got = sample_logits(torch.from_numpy(logits), gen, **kw).numpy()
        np.testing.assert_array_equal(got, np.asarray(jsample(jnp.asarray(logits),
                                                              jax.random.PRNGKey(0), **kw)))
        np.testing.assert_array_equal(got, [1, 0])
    ids = sample_logits(torch.from_numpy(logits), gen, temperature=torch.tensor([0.0, 0.1]))
    assert int(ids[0]) == 1


# ------------------------------------------------------- the world itself
def test_run_spmd_surfaces_a_raising_ranks_traceback():
    with pytest.raises(world.SpmdError, match="rank 1 of 2 raised") as err:
        world.run_spmd(cases.raising_rank, 2, backend="gloo", device="cpu", timeout_s=60)
    assert "ValueError: rank 1 fails on purpose" in str(err.value)
    assert "raising_rank" in str(err.value)  # the rank's own frames


def test_run_spmd_kills_a_hanging_world_at_its_deadline():
    import multiprocessing as mp
    import time

    t0 = time.monotonic()
    with pytest.raises(world.SpmdError, match="had no result after 6 s"):
        world.run_spmd(cases.hanging_rank, 2, backend="gloo", device="cpu", timeout_s=6)
    assert time.monotonic() - t0 < 30
    assert not [p for p in mp.active_children() if p.name.startswith("spmd-rank")]
    assert world.run_spmd(cases.rank_and_size, 2, backend="gloo", device="cpu",
                          timeout_s=60) == [(0, 2), (1, 2)]


def test_init_parallel_defaults_to_the_card_and_names_gloo(monkeypatch):
    import torch.distributed as dist

    def never(*a, **k):
        raise AssertionError("no process group may start here")

    monkeypatch.setattr(dist, "init_process_group", never)
    monkeypatch.setattr(torch.cuda, "set_device", never)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        world.init_parallel()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        world.run_spmd(cases.rank_and_size, 2)
    with pytest.raises(ValueError, match="needs the card"):
        world.init_parallel(backend="nccl", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="backend='gloo'"):
        world.init_parallel()  # nccl by default on the card; 4 ranks would share it
    with pytest.raises(ValueError, match="must be one of"):
        world.init_parallel(backend="mpi")


def test_leaf_paths_follow_the_references_keys():
    tree = {"layers": {"wq": 1, "attn_norm": 2}, "embedding": 3}
    seen = []
    map_with_path(lambda p, _leaf: seen.append(p), tree)
    ref = ["/".join(str(k.key) for k in path)
           for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert sorted(seen) == sorted(ref)
