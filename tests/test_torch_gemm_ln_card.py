"""The chains' shared GEMM on its ping-pong schedule and the LN backward on
bulk async copies, on the card, at the rows and widths the towers run.

Each GEMM instance the fused-block chains launch (the qkv and out products,
bf16 out with the staged epilogue; dctx, NT bf16; dh, NT fp32; dW_out and
dW_qkv, TN fp32 with the weight grads' split-K; and the LoRA fold's qkv,
out, dctx and dh, at ranks 4 and 8) at 1, 16, 64 rows of ViT-B/16's 197
tokens and 64 of ViT-L/14's 257, widths 512, 768 and 1024 (N up to 3072;
one round of tiles or fewer takes the cooperative split, more the
ping-pong schedule), against an fp32 ``torch.matmul`` of the same bf16
operands; the LN backward at those widths and 1, 7 and 3152 rows, x in
bf16 and fp32, against its plain version (``fba.ln_backward_reference``).
Two launches of each give the same bits.

Every test needs an NVIDIA GPU and nvcc (marker ``cuda``) and skips
without one. On the card, without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gemm_ln_card.py -q
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import types

import pytest
import torch

from lifelong_clip_tpu_torch.ops import fused_block_attn as fba
from lifelong_clip_tpu_torch.ops import kernel_check as kc

pytestmark = pytest.mark.cuda

BF = torch.bfloat16
ROWS = (197, 16 * 197, 64 * 197, 64 * 257)
WIDTHS = (512, 768, 1024)
PRODUCTS = ("qkv", "out", "dctx", "dh", "dw_out", "dw_qkv")
FOLDED = ("qkv", "out", "dctx", "dh")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _rnd(gen, *shape, std=1.0, dtype=BF):
    return (std * torch.randn(*shape, generator=gen,
                              device=gen.device)).to(dtype)


def _held(got, want, rel=1e-2):
    """Within ``rel`` of the output's max beyond one bf16 ulp of each
    element (fp32 sums in another order, one rounding to the output's
    dtype)."""
    got, want = got.float(), want.float()
    excess = ((got - want).abs()
              - kc.ULP * torch.maximum(got.abs(), want.abs())).clamp(min=0)
    tol = rel * float(want.abs().max())
    assert float(excess.max()) <= tol, (float(excess.max()), tol)


def _product(name, d, m, gen):
    """The chain's launch of ``name`` at width ``d`` over ``m`` rows, as a
    function of no argument returning its output, and that output's fp32
    reference: (launch, want)."""
    dev = gen.device
    scale = d ** 0.5
    if name in ("qkv", "out"):   # NN, bf16 out, bias (and the residual)
        n = 3 * d if name == "qkv" else d
        a, w = _rnd(gen, m, d), _rnd(gen, d, n)
        bias = scale * torch.randn(n, generator=gen, device=dev)
        resid = _rnd(gen, m, n, std=scale) if name == "out" else None
        want = a.float() @ w.float() + bias
        if resid is not None:
            want = want + resid.float()
        return (lambda: fba._gemm(torch.empty(m, n, dtype=BF, device=dev), a,
                                  (d, 1), w, (n, 1), m, n, d, bias=bias,
                                  resid=resid)), want
    if name in ("dctx", "dh"):   # NT: bf16 out over K = D, fp32 over 3D
        k = d if name == "dctx" else 3 * d
        odt = BF if name == "dctx" else torch.float32
        a, w = _rnd(gen, m, k), _rnd(gen, d, k)   # B(k, n) = w[n, k]
        return (lambda: fba._gemm(torch.empty(m, d, dtype=odt, device=dev),
                                  a, (k, 1), w, (1, k), m, d, k)), \
            a.float() @ w.float().T
    # TN over all m rows, fp32, the weight grads' split-K
    n = d if name == "dw_out" else 3 * d
    a, b = _rnd(gen, m, d), _rnd(gen, m, n)
    return (lambda: fba._gemm(torch.empty(d, n, device=dev), a, (1, d), b,
                              (n, 1), d, n, m, splits=-2)), \
        a.float().T @ b.float()


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("name", PRODUCTS)
def test_gemm_instance_matches_fp32_matmul(cuda, name, d, m):
    """Each product the chains launch at r = 0: within 1e-2 of the output's
    max beyond one bf16 ulp of the fp32 product; two launches bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(d * 7 + m)
    launch, want = _product(name, d, m, gen)
    out = launch()
    torch.cuda.synchronize()
    _held(out, want)
    assert kc.same_bits(out, launch())


def _folded(name, d, m, r, gen):
    """The folded LoRA launch of ``name`` (``fba._gemm_lora``) at rank ``r``
    as the chain makes it: (launch, a, f, lb, kw) with launch() -> (out, z,
    sums)."""
    dev = gen.device
    scale = d ** 0.5
    grads = name in ("dctx", "dh")
    k = 3 * d if name == "dh" else d
    n = 3 * d if name == "qkv" else d
    odt = torch.float32 if name == "dh" else BF
    a, f, lb = _rnd(gen, m, k), _rnd(gen, k, r), _rnd(gen, r, n)
    b = _rnd(gen, k, n)
    b_arg = (b.t().contiguous(), (1, k)) if grads else (b, (n, 1))
    zc = fba._z_cols(m)
    kw = {}
    if not grads:
        kw["bias"] = scale * torch.randn(n, generator=gen, device=dev)
    if name == "out":
        kw["resid"] = _rnd(gen, m, n, std=scale)
    nb = fba._lora_blocks(m)
    if grads:
        zin = torch.zeros(r, zc, dtype=BF, device=dev)
        zin[:, :m] = _rnd(gen, r, m)
        kw.update(zin=zin, xa=_rnd(gen, m, n),
                  pb=torch.empty(nb * r * k, device=dev),
                  pa=torch.empty(nb * n * r, device=dev))

    def launch():
        out = torch.empty(m, n, dtype=odt, device=dev)
        z_t = torch.empty(r, zc, dtype=BF, device=dev)
        fba._gemm_lora(out, a, (k, 1), *b_arg, m, n, k, f.t().contiguous(),
                       r, zalpha=1 / scale, lscale=scale / 2, lb=(lb, n, 1),
                       zout=z_t, **kw)
        sums = {}
        if grads:
            sums = {"b": torch.empty(r * k, device=dev),
                    "a": torch.empty(n * r, device=dev)}
            pp = types.SimpleNamespace(
                stream=torch.cuda.current_stream().cuda_stream)
            fba._sum_partials(pp, [(kw["pb"], nb, r * k, sums["b"], 1.0),
                                   (kw["pa"], nb, n * r, sums["a"], 1.0)])
        return out, z_t[:, :m].t(), sums

    return launch, a, b, f, lb, kw


@pytest.mark.parametrize("r", (4, fba.FOLD_RMAX))
@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("name", FOLDED)
def test_folded_gemm_instance_matches_fp32_matmul(cuda, name, d, m, r):
    """Each folded LoRA product (rank 4 and the fold's largest, 8): Z =
    bf16(A @ F / sqrt(D)) within
    one bf16 ulp and 1e-2 of its max, out = A @ B + s Z @ L (+ bias, +
    residual) as the unfolded products, the partials' sums of zin^T A and
    xa^T Z within 1e-4 of their max; two launches bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(d * 11 + m + r)
    launch, a, b, f, lb, kw = _folded(name, d, m, r, gen)
    out, z, sums = launch()
    torch.cuda.synchronize()
    k, scale = a.shape[1], d ** 0.5
    _held(z, a.float() @ f.float() / scale)
    want = a.float() @ b.float() + scale / 2 * (z.float() @ lb.float())
    for term in ("bias", "resid"):
        if term in kw:
            want = want + kw[term].float()
    _held(out, want)
    if sums:
        zin = kw["zin"][:, :a.shape[0]].float()
        for got_s, want_s in ((sums["b"].view(r, k), zin @ a.float()),
                              (sums["a"].view(-1, r),
                               kw["xa"].float().T @ z.float())):
            err = float((got_s - want_s).abs().max())
            assert err <= 1e-4 * float(want_s.abs().max()), err
    again = launch()
    assert kc.same_bits(out, again[0]) and kc.same_bits(z, again[1])
    for key in sums:
        assert kc.same_bits(sums[key], again[2][key]), key


@pytest.mark.parametrize("dtype", [BF, torch.float32])
@pytest.mark.parametrize("m", (1, 7, 3152))
@pytest.mark.parametrize("d", WIDTHS)
def test_ln_backward_matches_plain_version(cuda, d, m, dtype):
    """dx = g + LN'(x)^T dh, the kernel against ``ln_backward_reference``:
    within 1e-4 of dx's max beyond one bf16 ulp (the reference's fp32 sums
    run in another order); with the weight grads' workspace each row's
    (mean, rstd) within 1e-5 of the reference's; two launches bit for
    bit."""
    gen = torch.Generator(device=cuda).manual_seed(d + m)
    x = _rnd(gen, m, d, dtype=dtype) + 0.5
    gamma = 1 + 0.1 * _rnd(gen, d, dtype=dtype)
    dh = torch.randn(m, d, generator=gen, device=cuda)
    g = _rnd(gen, m, d, dtype=dtype)
    want, stats = fba.ln_backward_reference(x, gamma, dh, g)
    chunks = fba._ln_part_chunks(m, d)
    part = torch.empty(3 * chunks * d + 2 * m, device=cuda)
    got = fba.ln_backward(x, gamma, dh, g, part)
    torch.cuda.synchronize()
    _held(got, want, rel=1e-4)
    torch.testing.assert_close(part[3 * chunks * d:].view(m, 2), stats,
                               rtol=1e-5, atol=1e-5)
    assert kc.same_bits(got, fba.ln_backward(x, gamma, dh, g))
    assert kc.same_bits(got, fba.ln_backward(x, gamma, dh, g, part))


def test_ln_backward_refuses_rows_a_bulk_copy_cannot_move(cuda):
    """Rows of 200 bytes (D = 100 in bf16) are no multiple of 16 bytes, and
    D = 1032 is past the 1024 a lane's registers hold: the launcher raises,
    with no second road."""
    for d in (100, 1032):
        x = torch.randn(8, d, device=cuda).to(BF)
        gamma = torch.ones(d, device=cuda)
        dh = torch.randn(8, d, device=cuda)
        with pytest.raises(RuntimeError, match="llc_ln_bwd failed"):
            fba.ln_backward(x, gamma, dh, x)


@pytest.mark.parametrize("name,d,m", [("dctx", 1024, 64 * 257),
                                      ("dctx", 768, 64 * 197),
                                      ("dh", 1024, 64 * 257)])
def test_folded_grads_gemm_repeats_bit_for_bit(cuda, name, d, m):
    """The fold's partials on the ping-pong schedule (many tiles a block):
    24 launches give the first launch's out, Z and partials bit for bit.
    (A consumer that reached the xa stage's next fill while that stage was
    pending read the xa tile as its own: a tile of a few dozen launches
    came out wrong.)"""
    gen = torch.Generator(device=cuda).manual_seed(d + m)
    launch = _folded(name, d, m, 4, gen)[0]
    first = launch()
    torch.cuda.synchronize()
    for _ in range(23):
        again = launch()
        torch.cuda.synchronize()
        assert kc.same_bits(first[0], again[0])
        assert kc.same_bits(first[1], again[1])
        for key in first[2]:
            assert kc.same_bits(first[2][key], again[2][key]), key
