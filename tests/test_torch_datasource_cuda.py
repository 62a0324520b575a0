"""The device datasource's capture on the card, and the f32-out logits
GEMM's backward there (``cuda``-marked: each skips without a card; no JAX
here, so these run where JAX is not installed). Run on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_datasource_cuda.py``.

- a kernel wrapper (flash, bf16 paged) captured by ``TPUClient.compile``:
  each replay bit-equal to an eager call on the same inputs, the
  wrapper's counter moved once (at the capture) and never by a replay,
  the outputs fresh tensors, a wrong shape a ``TPUError``;
- two paged executables on one client, the second larger: the first
  graph keeps scratch of its own, so after the second capture grows the
  wrapper's per-stream cache and other tensors take what it let go of,
  the first still replays bit-equal to an eager call and writes into
  none of those tensors;
- a function that draws from a generator passed as ``generators=``, and
  one that draws from the card's default generator with no
  ``generators=``: each replay draws anew, as eager calls do;
- ``matmul_f32``'s backward against autograd of the f32 product on the
  same bf16 inputs: rel L2 <= 1e-2 (the gradient is rounded to bf16
  before the GEMM, as on the CPU)."""

import math

import pytest

torch = pytest.importorskip("torch")

from gofr_tpu_torch.datasource.tpu import TPUClient, TPUError  # noqa: E402
from gofr_tpu_torch.ops.flash_attention import flash_attention  # noqa: E402
from gofr_tpu_torch.ops.matmul import matmul_f32  # noqa: E402
from gofr_tpu_torch.ops.paged_attention import (  # noqa: E402
    paged_decode_attention,
    scratch_numel,
    split_layout,
)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the CUDA kernels have no CPU mode)")
    client = TPUClient()
    client.connect()
    yield client
    client.close()


@pytest.mark.cuda
def test_flash_capture_replays_bit_equal_and_counts_once(card):
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = dict(device="cuda", dtype=torch.bfloat16, generator=gen)
    q = torch.randn(1, 256, 32, 128, **shape)
    k = torch.randn(1, 256, 8, 128, **shape)
    v = torch.randn(1, 256, 8, 128, **shape)
    kv_len = torch.tensor([256], dtype=torch.int32, device="cuda")
    card.compile("flash", lambda a, b, c, n: flash_attention(a, b, c, n, causal=True),
                 q, k, v, kv_len)
    assert card._exec_meta["flash"]["captured_launches"] == {"flash_attention": 1}
    before = flash_attention.launches
    outs = []
    for scale in (1.0, 0.5):
        qs = (q * scale).contiguous()
        got = card.execute("flash", qs, k, v, kv_len, block=True)
        want = flash_attention(qs, k, v, kv_len, causal=True)
        assert torch.equal(got, want)
        outs.append(got)
    assert flash_attention.launches == before + 2  # the two eager calls only
    assert not torch.equal(outs[0], outs[1])  # fresh outputs, not one static buffer
    with pytest.raises(TPUError, match="argument 0"):
        card.execute("flash", q[:, :128].contiguous(), k, v, kv_len)


def _paged_inputs(gen, lens, page=16):
    """(q, k_pool, v_pool, tables, seq_lens) of bf16 paged decode over
    random page ids, 32 query heads over 8 kv heads of 128."""
    B = len(lens)
    M = max(math.ceil(s / page) for s in lens)
    N = sum(math.ceil(s / page) for s in lens) + 8
    tables = torch.randint(0, N - 1, (B, M), generator=gen, device="cuda", dtype=torch.int32)
    kp = torch.randn(N, 8, page, 128, generator=gen, device="cuda", dtype=torch.bfloat16)
    vp = torch.randn(N, 8, page, 128, generator=gen, device="cuda", dtype=torch.bfloat16)
    q = torch.randn(B, 32, 128, generator=gen, device="cuda", dtype=torch.bfloat16)
    seq_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, kp, vp, tables, seq_lens


@pytest.mark.cuda
def test_paged_capture_replays_bit_equal(card):
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, kp, vp, tables, seq_lens = _paged_inputs(gen, [17, 300, 1, 64])
    B = q.shape[0]
    card.compile("paged", paged_decode_attention, q, kp, vp, tables, seq_lens)
    assert card._exec_meta["paged"]["captured_launches"] == {"paged_decode_attention": 1}
    for _ in range(2):
        q2 = torch.randn(B, 32, 128, generator=gen, device="cuda", dtype=torch.bfloat16)
        got = card.execute("paged", q2, kp, vp, tables, seq_lens, block=True)
        assert torch.equal(got, paged_decode_attention(q2, kp, vp, tables, seq_lens))


@pytest.mark.cuda
def test_a_paged_graph_keeps_its_scratch_when_a_larger_one_is_captured(card):
    gen = torch.Generator(device="cuda").manual_seed(4)
    small = _paged_inputs(gen, [300])
    large = _paged_inputs(gen, [17, 300, 1, 64, 999, 128, 2000, 5])
    card.compile("paged_1", paged_decode_attention, *small)
    card.compile("paged_8", paged_decode_attention, *large)
    # the per-stream cache now holds the larger buffers: hand what it let go
    # of to other tensors on the capture stream, where those were allocated
    _, n_splits = split_layout(small[3].shape[1], 16)
    with torch.cuda.stream(card._stream):
        floats = [torch.full((scratch_numel(1, 8, 4, 128, n_splits),), float("nan"),
                             device="cuda") for _ in range(32)]
        ints = [torch.full((8,), 7, dtype=torch.int32, device="cuda") for _ in range(32)]
    torch.cuda.synchronize()
    for _ in range(2):
        for name, args in (("paged_1", small), ("paged_8", large)):
            got = card.execute(name, *args, block=True)
            assert torch.equal(got, paged_decode_attention(*args)), name
    assert all(bool(torch.isnan(t).all()) for t in floats)
    assert all(bool((t == 7).all()) for t in ints)


@pytest.mark.cuda
def test_the_default_generator_draws_anew_on_each_replay(card):
    card.compile("noise", lambda x: x + torch.rand(x.shape, device=x.device),
                 torch.zeros(1024, device="cuda"))
    a = card.execute("noise", torch.zeros(1024, device="cuda"), block=True)
    b = card.execute("noise", torch.zeros(1024, device="cuda"), block=True)
    assert not torch.equal(a, b)
    assert 0.4 < float(a.mean()) < 0.6 and 0.4 < float(b.mean()) < 0.6


@pytest.mark.cuda
def test_a_registered_generator_draws_anew_on_each_replay(card):
    gen = torch.Generator(device="cuda").manual_seed(2)
    card.compile("noise", lambda x: x + torch.rand(x.shape, generator=gen, device=x.device),
                 torch.zeros(1024, device="cuda"), generators=(gen,))
    a = card.execute("noise", torch.zeros(1024, device="cuda"), block=True)
    b = card.execute("noise", torch.zeros(1024, device="cuda"), block=True)
    assert not torch.equal(a, b)
    assert 0.4 < float(a.mean()) < 0.6 and 0.4 < float(b.mean()) < 0.6


@pytest.mark.cuda
def test_matmul_f32_backward_on_the_card(card):
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(64, 512, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn(512, 1000, generator=gen, device="cuda").to(torch.bfloat16)
    up = torch.randn(64, 1000, generator=gen, device="cuda")
    xa, wa = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    ((xa.float() @ wa.float()) * up).sum().backward()
    xb, wb = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = matmul_f32(xb, wb)
    assert y.dtype == torch.float32 and y.grad_fn is not None
    (y * up).sum().backward()
    for got, want in ((xb.grad, xa.grad), (wb.grad, wa.grad)):
        assert got.dtype == torch.bfloat16
        assert float((got.float() - want.float()).norm() / want.float().norm()) <= 1e-2
