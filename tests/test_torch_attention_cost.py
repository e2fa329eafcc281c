"""The attention's own cost in ``chip_smoke.py`` (``attention_cost``: the
bound printed beside the attention kernels' device ms) against counts by
hand, the fused block's cost (``block_cost``) built on it, and the
attention timing tool's bit comparison (``tools/torch_attn_time.py``). CPU
only: both files are loaded by path, as the tools load ``chip_smoke.py``."""

import torch_threads  # noqa: F401  (the worker's share of the cores)

import importlib.util
import json
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load("chip_smoke", "chip_smoke.py")
attn_time = _load("torch_attn_time", os.path.join("tools",
                                                  "torch_attn_time.py"))


def test_vision_shape_by_hand():
    """ViT-B/16's vision block, 64 x 197 x 768, 12 heads of 64: the forward
    reads q, k, v and writes ctx (4 x 12608 rows x 768 x 2 B), 2 products;
    the backward reads q, k, v, dctx and writes dq, dk, dv (7 x ...), 5
    products, 19.1 GFLOP; bound by its bytes at 3.35 TB/s."""
    b, t, d, heads = 64, 197, 768, 12
    fl, by = cs.attention_cost(b, t, d, heads, False)
    assert fl == 2 * 2 * 64 * 12 * 197 * 197 * 64
    assert by == 4 * 12608 * 768 * 2 == 77_463_552
    fl, by = cs.attention_cost(b, t, d, heads, True)
    assert fl == 5 * 2 * 64 * 12 * 197 * 197 * 64
    assert round(fl / 1e9, 1) == 19.1
    assert by == 7 * 12608 * 768 * 2 == 135_561_216
    ms, what = cs.bound_ms(fl, by)
    assert what == "bytes"
    assert ms == pytest.approx(135_561_216 / 3.35e12 * 1e3)


@pytest.mark.parametrize("backward,products", [(False, 2), (True, 5)])
def test_causal_pairs_by_hand(backward, products):
    """The text tower's causal (77, 77) mask leaves 77 x 78 / 2 = 3003
    (query, key) pairs a head: the products count those; the bytes do not
    change."""
    b, t, d, heads = 100, 77, 512, 8
    fl, by = cs.attention_cost(b, t, d, heads, backward, pairs=3003)
    assert fl == products * 2 * 100 * 8 * 3003 * 64
    assert by == cs.attention_cost(b, t, d, heads, backward)[1]


def test_prefix_keys_by_hand():
    """With S = P + T keys (the KV-prefix block, P = 5 live): q and dctx
    T rows, k, v, dk, dv S rows each."""
    b, t, s, d, heads = 64, 197, 202, 768, 12
    fl, by = cs.attention_cost(b, t, d, heads, True, keys=s)
    assert fl == 5 * 2 * b * heads * t * s * 64
    assert by == (3 * t + 4 * s) * b * d * 2
    fl, by = cs.attention_cost(b, t, d, heads, False, keys=s)
    assert fl == 2 * 2 * b * heads * t * s * 64
    assert by == (2 * t + 2 * s) * b * d * 2


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("r,weight_grads", [(0, False), (4, False),
                                            (0, True), (4, True)])
@pytest.mark.parametrize("pairs", [None, 197 * 198 // 2])
def test_block_cost_attention_is_attention_cost(backward, r, weight_grads,
                                                pairs):
    """``block_cost``'s attention FLOPs, what it counts beyond the same block
    with no live pair, are ``attention_cost``'s."""
    b, t, d, heads = 16, 197, 768, 12
    whole = cs.block_cost(b, t, d, heads, r, weight_grads, backward,
                          pairs=pairs)[0]
    rest = cs.block_cost(b, t, d, heads, r, weight_grads, backward,
                         pairs=0)[0]
    assert whole - rest == cs.attention_cost(b, t, d, heads, backward,
                                             pairs=pairs)[0]


def test_ulps_counts_units_in_the_last_place():
    """bf16 neighbours 1 ulp apart on both sides of zero, +0 and -0 equal,
    a NaN against a number unmeasurable."""
    a = torch.tensor([1.0, -1.0, 0.0, 2.0, 0.0], dtype=torch.bfloat16)
    step = torch.tensor([1, 1, 1, -2, 0], dtype=torch.int16)
    b = (a.view(torch.int16) + step).view(torch.bfloat16)
    assert attn_time.ulps(a, b) == 2
    assert attn_time.ulps(a[:3], b[:3]) == 1
    assert attn_time.ulps(torch.tensor([0.0], dtype=torch.bfloat16),
                          torch.tensor([-0.0], dtype=torch.bfloat16)) == 0
    f = torch.tensor([1.0, float("nan")])
    assert attn_time.ulps(f, torch.tensor([1.0, 2.0])) != \
        attn_time.ulps(f, torch.tensor([1.0, 2.0]))   # NaN


def test_compare_reports_bit_equal_shares(tmp_path, capsys):
    """``--compare``: the share of bit-equal elements, how many differ and
    the largest ulp distance of each row's outputs."""
    x = torch.arange(8, dtype=torch.float32).to(torch.bfloat16)
    y = x.clone()
    y[3] = (y[3:4].view(torch.int16) + 3).view(torch.bfloat16)[0]
    part = torch.ones(4)
    torch.save({"row": {"ctx16": x, "bias_partials": part}}, tmp_path / "a")
    torch.save({"row": {"ctx16": y, "bias_partials": part}}, tmp_path / "b")
    assert attn_time.compare(str(tmp_path / "a"), str(tmp_path / "b")) == 0
    out = json.loads(capsys.readouterr().out)["rows"]["row"]
    assert out["ctx16"] == {"bit_equal_share": 7 / 8, "differing": 1,
                            "max_ulps": 3}
    assert out["bias_partials"] == {"bit_equal_share": 1.0, "differing": 0,
                                    "max_ulps": 0}
