"""The port's kerneltrace (gofr_tpu_torch/analysis/kerneltrace.py): the
CPU matrix against the JAX package's eval_shape matrix and against the
port's contract table, and the live-engine observer.

Both matrices run at their package's ``tiny`` config and the same sizes.
Every (kernel, variant) case has the same output shapes in both, and the
same dtypes but for the carry's deliberate differences (ROADMAP Queue C
3): ``last_token``, ``stop_tok`` and ``top_k`` are int64, and the
sampling state is a ``torch.Generator`` (one leaf, its device only) where
the reference carries a ``[2] uint32`` key. The spec entries return no
key (the generator advances in place), so their ``rng`` output has no
twin (Queue C 3). Any other difference fails.
"""

from __future__ import annotations

import json

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from gofr_tpu.analysis import kernel_contracts as jkc  # noqa: E402
from gofr_tpu.analysis import kerneltrace as jkerneltrace  # noqa: E402
from gofr_tpu_torch.analysis import kernel_contracts as kc  # noqa: E402
from gofr_tpu_torch.analysis import kerneltrace  # noqa: E402
from gofr_tpu_torch.analysis.kernelcheck import check_kernel_table  # noqa: E402

# the reference matrix's (kernel, variant) cases, in its order
MATRIX_CASES = [
    ("prefill_compute", "dense"),
    ("insert_slot", "dense"),
    ("insert_slot_quantized", "quantized"),
    ("insert_chunk", "dense"),
    ("admit_decode_state", "dense"),
    ("decode_block", "dense.b3n4"),
    ("decode_block", "dense.b2n2"),
    ("decode_block", "dense.lora"),
    ("decode_block", "dense.q"),
    ("decode_block_paged", "paged"),
    ("decode_block_paged", "paged.lora"),
    ("decode_block_paged_q", "paged.q"),
    ("ragged_step", "dense.b3n4"),
    ("ragged_step", "dense.b2n2"),
    ("ragged_step", "dense.lora"),
    ("ragged_step_paged", "paged"),
    ("ragged_step_paged_q", "paged.q"),
    ("verify_and_sample", "spec.dense"),
    ("verify_and_sample_paged", "spec.paged"),
    ("verify_and_sample_paged_q", "spec.paged.q"),
    ("lora_adjust_logits", "lora"),
    ("_write_pages", "paged"),
    ("_write_pages_q", "paged.q"),
    ("paged_decode_attention", "paged"),
    ("paged_decode_attention_q", "paged.q"),
    ("flash_attention", "flash"),
]
# carry field index -> (reference leaf, port leaf), Queue C 3
CARRY_DIFFERENCES = {
    0: ("int32", "int64"),  # last_token
    4: ("int32", "int64"),  # stop_tok
    6: ("int32", "int64"),  # top_k
    8: ([[2], "uint32"], [[], "generator:cpu"]),  # rng: key vs Generator
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _launches() -> dict:
    from gofr_tpu_torch.ops import flash_attention as fa
    from gofr_tpu_torch.ops import paged_attention as pa

    return {"flash": fa.flash_attention.launches,
            "paged": pa.paged_decode_attention.launches,
            "paged_q": pa.paged_decode_attention_q.launches}


@pytest.fixture(scope="module")
def matrices():
    before = _launches()
    port = kerneltrace.run_matrix()
    assert _launches() == before  # CPU tensors: every wrapper took its plain version
    return jkerneltrace.run_matrix(), port


def _by_case(payload) -> dict:
    return {(c["kernel"], c["variant"]): c for c in payload["cases"]}


def test_matrix_zero_divergence_against_the_table(matrices):
    _, port = matrices
    assert check_kernel_table(port) == []


def test_matrix_covers_every_contract(matrices):
    _, port = matrices
    assert {c["kernel"] for c in port["cases"]} == set(kc.CONTRACTS)


def test_matrix_cases_are_the_reference_cases(matrices):
    ref, port = matrices
    assert list(_by_case(ref)) == list(_by_case(port)) == MATRIX_CASES


def _expected_port_leaves(ref_leaves: list, name: str) -> list:
    if name != "state":
        return ref_leaves
    out = []
    for i, (shape, dtype) in enumerate(ref_leaves):
        diff = CARRY_DIFFERENCES.get(i)
        if diff is None:
            out.append([shape, dtype])
        elif isinstance(diff[1], list):
            assert [shape, dtype] == diff[0]
            out.append(diff[1])
        else:
            assert dtype == diff[0]
            out.append([shape, diff[1]])
    return out


@pytest.mark.parametrize("case", MATRIX_CASES)
def test_case_signatures_match_the_reference(matrices, case):
    ref, port = (_by_case(m)[case] for m in matrices)
    ref_names = [r.name for r in jkc.CONTRACTS[case[0]].returns]
    port_names = [r.name for r in kc.CONTRACTS[case[0]].returns]
    ref_outs = dict(zip(ref_names, ref["outputs"]))
    port_outs = dict(zip(port_names, port["outputs"]))
    unmatched = set(ref_outs) - set(port_outs)
    assert unmatched <= ({"rng"} if case[0].startswith("verify_and_sample") else set())
    for name, got in port_outs.items():
        want = _expected_port_leaves(ref_outs[name]["leaves"], name)
        assert got["leaves"] == want, (case, name)


def test_export_round_trips_through_the_cli(tmp_path, capsys):
    from gofr_tpu_torch.analysis.__main__ import main

    path = tmp_path / "matrix.json"
    assert kerneltrace.main(["--out", str(path)]) == 0
    assert main(["--check-kernel-table", str(path)]) == 0
    doctored = json.loads(path.read_text())
    case = next(c for c in doctored["cases"] if c["kernel"] == "decode_block")
    case["outputs"][0]["leaves"][0][0][1] += 1  # a packed width drift
    path.write_text(json.dumps(doctored))
    assert main(["--check-kernel-table", str(path)]) == 1
    assert "by the contract, observed" in capsys.readouterr().out


def test_signature_is_metadata_only():
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.serving import batch

    cache = llama.KVCache.create(llama.LlamaConfig.tiny(), 2, max_len=8, device="cpu")
    state = batch.make_decode_state([1, 2], [3, 4], [False, False], [5, 5], [-1, -1],
                                    [0.0, 0.0], [0, 0], [1.0, 1.0],
                                    torch.Generator().manual_seed(0), device=torch.device("cpu"))
    sig = kerneltrace.signature((cache, state, None, 3))
    assert sig["tree"].startswith("tuple(KVCache(k=*, v=*, ks=None, vs=None), DecodeState(")
    assert [leaf[1] for leaf in sig["leaves"]][-2:] == ["int32", "int"]
    assert [[], "generator:cpu"] in sig["leaves"]


# ------------------------------------------------------- the live observer
def _serve(layout: str, kv_dtype: str, spec: int, prompts: list) -> None:
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine

    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    conf = dict(max_slots=4, max_seq_len=128, kv_layout=layout, kv_dtype=kv_dtype,
                kv_page_size=8, prefill_chunk_tokens=16, multi_step=2)
    if spec:
        conf = dict(conf, spec_tokens=spec, multi_step=1)
    engine = ServingEngine(cfg, params, EngineConfig(**conf), device="cpu")
    engine.start()
    try:
        for f in [engine.submit(p, max_new_tokens=5) for p in prompts]:
            f.result(timeout=120)
    finally:
        engine.stop()


@pytest.mark.parametrize("layout,kv_dtype,spec,expect", [
    ("paged", "bf16", 0, {"prefill_compute", "_write_pages", "decode_block_paged",
                          "ragged_step_paged", "flash_attention", "paged_decode_attention"}),
    ("paged", "int8", 0, {"_write_pages_q", "decode_block_paged_q", "ragged_step_paged_q",
                          "paged_decode_attention_q"}),
    ("dense", "bf16", 0, {"insert_slot", "decode_block", "ragged_step"}),
    ("dense", "int8", 0, {"insert_slot_quantized", "decode_block"}),
    ("dense", "bf16", 3, {"verify_and_sample"}),
    ("paged", "int8", 3, {"verify_and_sample_paged_q"}),
])
def test_observer_on_a_live_engine_matches_the_table(layout, kv_dtype, spec, expect):
    prompts = [list(range(3, 3 + n)) for n in (5, 9, 40, 12, 7)]
    obs = kerneltrace.KernelObserver().install()
    try:
        _serve(layout, kv_dtype, spec, prompts)
    finally:
        obs.uninstall()
    payload = obs.export()
    assert payload["violations"] == []
    assert check_kernel_table(payload) == []
    assert all(obs.counts.get(name) for name in expect), obs.counts


def test_observer_uninstall_is_exact_and_counters_stay_on_the_wrappers():
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.ops import flash_attention as fa
    from gofr_tpu_torch.serving import batch
    from gofr_tpu_torch.serving import kv_cache

    before = {(m.__name__, k.name): getattr(m, k.name)
              for k in kc.KERNELS
              for m in (batch, kv_cache, llama) if hasattr(m, k.name)}
    obs = kerneltrace.KernelObserver().install()
    try:
        assert llama.flash_attention is not fa.flash_attention
        assert not hasattr(llama.flash_attention, "launches")
        assert batch.decode_block.__kerneltrace_wrapped__ is before[(batch.__name__,
                                                                     "decode_block")]
    finally:
        obs.uninstall()
    after = {(m.__name__, k.name): getattr(m, k.name)
             for k in kc.KERNELS
             for m in (batch, kv_cache, llama) if hasattr(m, k.name)}
    assert after == before
    assert llama.flash_attention is fa.flash_attention
