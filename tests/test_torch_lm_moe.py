"""The MoE layer, port against reference, on the CPU: `route_topk` (softmax
and sigmoid routers), `expert_capacity`, `load_balance_loss` and `moe_ffn`
with capacity drops, shared experts and squared ReLU, fed the same numpy
inputs.

Expert ids are also held, in order, on bf16-quantised logits that tie
(few levels, and routers with repeated columns), for both routers at E = 8
and 256: the lower expert id first among equal gates, as `jax.lax.top_k`
orders them.

Expert ids and the drop mask are held exactly: the ids against the
reference's `route_topk`, the port's drop mask and slots against a numpy
transcription of the reference's rule (assignment j of token t, in the
flattened order t·k + j, is kept while fewer than C earlier assignments
chose its expert).  Float outputs within 1e-5 in f32, 2e-2 in bf16.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as RM
from repro.models.lm_config import MoEConfig as RefMoEConfig
from repro_torch.models import moe as M
from repro_torch.models.lm_config import MoEConfig

F32_TOL = 1e-5
BF16_TOL = 2e-2


def _cfgs(**kw):
    return RefMoEConfig(**kw), MoEConfig(**kw)


def _close(got, want, tol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, dtype=np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
@pytest.mark.parametrize("E,k", [(4, 2), (8, 2), (256, 8)])
def test_route_topk_matches(router, E, k):
    rng = np.random.default_rng(E * 10 + k)
    logits = rng.standard_normal((200, E)).astype(np.float32)
    ref_cfg, cfg = _cfgs(n_experts=E, top_k=k, d_expert=8, router=router)
    w, experts, probs = M.route_topk(torch.from_numpy(logits), cfg)
    rw, rexperts, rprobs = RM.route_topk(jnp.asarray(logits), ref_cfg)
    assert experts.dtype == torch.int32
    np.testing.assert_array_equal(experts.numpy(), np.asarray(rexperts))
    _close(w, rw, F32_TOL)
    _close(probs, rprobs, F32_TOL)


def _tied_logits(rng, N, E, levels):
    """bf16 logits on `levels` values: most rows tie across the k-th place."""
    q = rng.integers(0, levels, (N, E)).astype(np.float32) * 0.25
    return torch.from_numpy(q).to(torch.bfloat16).to(torch.float32).numpy()


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
@pytest.mark.parametrize("E,k", [(8, 2), (256, 8)])
def test_route_topk_ties_match_in_order(router, E, k):
    rng = np.random.default_rng(E + k + (router == "sigmoid"))
    logits = _tied_logits(rng, 300, E, levels=3 if E == 8 else 5)
    ref_cfg, cfg = _cfgs(n_experts=E, top_k=k, d_expert=8, router=router)
    w, experts, _ = M.route_topk(torch.from_numpy(logits), cfg)
    rw, rexperts, _ = RM.route_topk(jnp.asarray(logits), ref_cfg)
    np.testing.assert_array_equal(experts.numpy(), np.asarray(rexperts))
    _close(w, rw, F32_TOL)
    # the rows really tie across the k-th place
    srt = np.sort(logits, axis=1)[:, ::-1]
    assert (srt[:, k - 1] == srt[:, k]).mean() > 0.5


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
def test_route_topk_minimal_tie(router):
    """Gates [0,1,1,1,0,1,1,1], k = 2: experts [1, 2] (`torch.topk` gives
    [6, 5] on the CPU)."""
    logits = np.array([[0, 1, 1, 1, 0, 1, 1, 1]], np.float32)
    ref_cfg, cfg = _cfgs(n_experts=8, top_k=2, d_expert=8, router=router)
    _, experts, _ = M.route_topk(torch.from_numpy(logits), cfg)
    _, rexperts, _ = RM.route_topk(jnp.asarray(logits), ref_cfg)
    np.testing.assert_array_equal(np.asarray(rexperts), [[1, 2]])
    np.testing.assert_array_equal(experts.numpy(), [[1, 2]])


def test_top_k_keeps_the_gradient():
    x = torch.tensor([[0.0, 1.0, 1.0, 0.5]], requires_grad=True)
    v, i = M.top_k(x, 2)
    v.sum().backward()
    np.testing.assert_array_equal(i.numpy(), [[1, 2]])
    np.testing.assert_array_equal(x.grad.numpy(), [[0, 1, 1, 0]])


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
@pytest.mark.parametrize("E,k", [(8, 2), (256, 8)])
def test_moe_ffn_ties_match_in_order(router, E, k):
    """bf16 tokens through a bf16 router whose columns repeat a few
    distinct ones: every token's logits tie across experts.  The expert ids
    `moe_ffn` routes by, in order, and its output are the reference's."""
    D, N, F = 16, 64, 8
    rng = np.random.default_rng(E * 3 + k)
    ref_cfg, cfg = _cfgs(n_experts=E, top_k=k, d_expert=F, router=router,
                         capacity_factor=4.0)
    p = _moe_params(rng, E, D, F, 0, "swiglu")
    distinct = rng.standard_normal((D, 3)).astype(np.float32)
    p["router"] = distinct[:, rng.integers(0, 3, E)]
    x = rng.standard_normal((N, D)).astype(np.float32)
    tp = {k_: torch.from_numpy(v).to(torch.bfloat16) for k_, v in p.items()}
    rp = {k_: jnp.asarray(v).astype(jnp.bfloat16) for k_, v in p.items()}
    tx = torch.from_numpy(x).to(torch.bfloat16)
    rx = jnp.asarray(x).astype(jnp.bfloat16)
    seen, assign = [], M.assign_slots

    def recording(e, n_experts, capacity):
        seen.append(e.clone())
        return assign(e, n_experts, capacity)

    M.assign_slots = recording
    try:
        out, _ = M.moe_ffn(tp, tx, cfg, "swiglu")
    finally:
        M.assign_slots = assign
    _, rexperts, _ = RM.route_topk(rx @ rp["router"], ref_cfg)
    np.testing.assert_array_equal(seen[0].numpy(), np.asarray(rexperts))
    rout, _ = RM.moe_ffn(rp, rx, ref_cfg, "swiglu")
    _close(out, rout, BF16_TOL)


def test_expert_capacity_matches():
    for E, k, cf in ((4, 2, 0.5), (8, 2, 1.25), (256, 8, 1.25), (8, 2, 8.0)):
        ref_cfg, cfg = _cfgs(n_experts=E, top_k=k, d_expert=8, capacity_factor=cf)
        for n in (1, 2, 7, 64, 2048, 32768):
            assert M.expert_capacity(n, cfg) == RM.expert_capacity(n, ref_cfg)


def test_load_balance_loss_matches():
    rng = np.random.default_rng(5)
    probs = rng.random((50, 6)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    experts = rng.integers(0, 6, (50, 2)).astype(np.int32)
    got = M.load_balance_loss(torch.from_numpy(probs), torch.from_numpy(experts), 6)
    _close(got, RM.load_balance_loss(jnp.asarray(probs), jnp.asarray(experts), 6), F32_TOL)


def _oracle_slots(experts: np.ndarray, C: int):
    """keep and slot by the reference's rule, one assignment at a time."""
    seen = {}
    rank = np.zeros(experts.size, np.int64)
    for i, e in enumerate(experts.reshape(-1)):
        rank[i] = seen.get(int(e), 0)
        seen[int(e)] = rank[i] + 1
    return (rank < C).reshape(experts.shape), np.clip(rank, 0, C - 1).reshape(experts.shape)


MOE_CASES = {
    # name: (MoE fields, act, D, N)
    "drops_cf0.5": (dict(n_experts=4, top_k=2, d_expert=32, capacity_factor=0.5), "swiglu", 16, 64),
    "shared_sigmoid": (dict(n_experts=8, top_k=2, d_expert=24, n_shared=1,
                            router="sigmoid"), "swiglu", 16, 48),
    "relu2": (dict(n_experts=4, top_k=2, d_expert=32), "relu2", 16, 40),
    "relu2_shared_drops": (dict(n_experts=6, top_k=3, d_expert=16, n_shared=2,
                                capacity_factor=0.7), "relu2", 12, 30),
    "one_token": (dict(n_experts=8, top_k=2, d_expert=16), "swiglu", 16, 1),
}


def _moe_params(rng, E, D, F, n_shared, act):
    p = {
        "router": rng.standard_normal((D, E)).astype(np.float32),
        "we1": (rng.standard_normal((E, D, F)) * 0.1).astype(np.float32),
        "we2": (rng.standard_normal((E, F, D)) * 0.1).astype(np.float32),
    }
    if act == "swiglu":
        p["we3"] = (rng.standard_normal((E, D, F)) * 0.1).astype(np.float32)
    if n_shared:
        p["ws1"] = (rng.standard_normal((D, F * n_shared)) * 0.1).astype(np.float32)
        p["ws2"] = (rng.standard_normal((F * n_shared, D)) * 0.1).astype(np.float32)
        if act == "swiglu":
            p["ws3"] = (rng.standard_normal((D, F * n_shared)) * 0.1).astype(np.float32)
    return p


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_ffn_matches(case):
    fields, act, D, N = MOE_CASES[case]
    ref_cfg, cfg = _cfgs(**fields)
    rng = np.random.default_rng(sorted(MOE_CASES).index(case))
    p = _moe_params(rng, cfg.n_experts, D, cfg.d_expert, cfg.n_shared, act)
    x = rng.standard_normal((N, D)).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    out, metrics = M.moe_ffn(tp, torch.from_numpy(x), cfg, act)
    rout, rmetrics = RM.moe_ffn({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), ref_cfg, act)
    _close(out, rout, F32_TOL)
    _close(metrics.aux_loss, rmetrics.aux_loss, F32_TOL)
    _close(metrics.drop_frac, rmetrics.drop_frac, F32_TOL)

    # expert ids exactly, and the drop mask and slots against the rule
    logits = torch.from_numpy(x) @ tp["router"]
    _, experts, _ = M.route_topk(logits, cfg)
    _, rexperts, _ = RM.route_topk(jnp.asarray(x) @ jnp.asarray(p["router"]), ref_cfg)
    np.testing.assert_array_equal(experts.numpy(), np.asarray(rexperts))
    C = M.expert_capacity(N, cfg)
    slots = M.assign_slots(experts, cfg.n_experts, C)
    keep, slot = _oracle_slots(experts.numpy(), C)
    np.testing.assert_array_equal(slots.keep.numpy(), keep)
    np.testing.assert_array_equal(slots.slot.numpy()[keep], slot[keep])
    # each kept assignment's token fills its slot; nothing else is filled
    tok = slots.tok_for_slot.numpy()
    e_np = experts.numpy()
    for t, j in zip(*np.nonzero(keep)):
        assert tok[e_np[t, j], slot[t, j]] == t
    assert int(slots.slot_valid.sum()) == int(keep.sum())
    assert round(float(rmetrics.drop_frac) * keep.size) == keep.size - int(keep.sum())
    if case.startswith("drops") or case.endswith("drops"):
        assert float(metrics.drop_frac) > 0.0


def test_moe_ffn_bf16_matches():
    fields, act, D, N = MOE_CASES["shared_sigmoid"]
    ref_cfg, cfg = _cfgs(**fields)
    rng = np.random.default_rng(11)
    p = _moe_params(rng, cfg.n_experts, D, cfg.d_expert, cfg.n_shared, act)
    x = rng.standard_normal((N, D)).astype(np.float32)
    # the router stays f32, as in the reference's init; the experts are bf16
    tp = {k: torch.from_numpy(v).to(torch.float32 if k == "router" else torch.bfloat16)
          for k, v in p.items()}
    rp = {k: jnp.asarray(v).astype(jnp.float32 if k == "router" else jnp.bfloat16)
          for k, v in p.items()}
    out, metrics = M.moe_ffn(tp, torch.from_numpy(x).to(torch.bfloat16), cfg, act)
    rout, rmetrics = RM.moe_ffn(rp, jnp.asarray(x).astype(jnp.bfloat16), ref_cfg, act)
    assert out.dtype == torch.bfloat16
    _close(out, rout, BF16_TOL)
    _close(metrics.drop_frac, rmetrics.drop_frac, F32_TOL)


def test_moe_config_fields_are_the_reference_s_but_its_layout_knobs():
    ref = {f.name: f.default for f in dataclasses.fields(RefMoEConfig)}
    port = {f.name: f.default for f in dataclasses.fields(MoEConfig)}
    assert set(ref) - set(port) == {"shard_experts"}
    assert {k: ref[k] for k in port} == port
