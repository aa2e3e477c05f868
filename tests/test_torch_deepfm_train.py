"""DeepFM training on the port (`deepfm_loss`, the bag's backward,
`configs.deepfm.train_step`, AdamW) against the JAX reference: the same
weights (drawn by the reference's `deepfm_init`, carried by
`deepfm_params_from_numpy`), the same optimizer state (the reference's
`adamw_init` / `adamw_update`, carried by `adamw_state_from_numpy`) and the
same numpy batches go through both packages.  On the CPU both bag sums of
a forward and their backward run the kernels' plain versions.

Tolerances: the loss within 1e-6 (a mean of O(1) f32 terms summed in
another order); each gradient allclose(rtol=1e-5, atol=1e-7) to `jax.grad`
(sums of up to B·F f32 terms in another order: the bag's backward in slot
order against XLA's scatter-add, addmm against dot); one AdamW update
within 1e-6 (elementwise f32 on equal inputs; `pow` and `cos` may differ
by an ulp); ten steps: the loss of every step, the moments and every
well-conditioned parameter within 1e-5 (the gradient differences above,
ten times through the update).

Well-conditioned: AdamW moves a parameter by lr · m̂ / (√v̂ + eps), so
where a gradient sits at the f32 rounding floor of its sum (|g| ~ 1e-8;
the two packages' gradients differ by up to ~2.4e-8 on the skewed config)
the normalised step of O(lr) follows that rounding, and no tolerance below
lr holds it.  A parameter counts as well-conditioned where its
bias-corrected √v̂ after the ten steps is at least 1e-6 (a gradient
difference of 1e-8 moves its step by 1 % at most) or v is exactly 0 (no
gradient reached it).  The skewed config at lr 3e-3 has two elements of
180,480 in `embed` past 1e-5 (3.2e-5), both with √v̂ below 1e-8; the
well-conditioned ones, 97 % of its 676,130 parameters, agree within 3e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepfm as ref_configs
from repro.kernels.ref import embedding_bag_ref
from repro.models import deepfm as R
from repro.train import optimizer as RO
from repro_torch.configs import deepfm as C
from repro_torch.data.pipeline import ClickStream
from repro_torch.hopper import embedding_bag as E
from repro_torch.models import deepfm as M
from repro_torch.train import optimizer as O

LOSS_TOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-7
UPDATE_TOL = 1e-6
STEPS_TOL = 1e-5
WELL_CONDITIONED = 1e-6     # bias-corrected √v̂, see the module docstring

SKEWED = tuple([64] * 13 + [max(16, (v // 2000 + 15) // 16 * 16) for v in C._CAT])
CONFIGS = {
    "smoke": (C.SMOKE_CONFIG, ref_configs.SMOKE_CONFIG),
    "skewed": (M.DeepFMConfig(field_vocabs=SKEWED), R.DeepFMConfig(field_vocabs=SKEWED)),
}
# tests/test_recsys.py's test_training_reduces_loss
RECSYS_OPT = dict(lr=3e-3, warmup_steps=5, total_steps=100, weight_decay=0.0)
OPTS = {"train_batch": {}, "recsys": RECSYS_OPT}


def _pair(name, seed=0):
    """(port model on the CPU, reference params as numpy, port cfg, ref cfg)."""
    cfg, ref_cfg = CONFIGS[name]
    params = jax.tree.map(np.asarray, R.deepfm_init(jax.random.key(seed), ref_cfg))
    model = M.DeepFM(cfg, device="cpu")
    model.load_state_dict(M.deepfm_params_from_numpy(params))
    return model, params, cfg, ref_cfg


def _batch(cfg, B, step, seed=1):
    return ClickStream(cfg.field_vocabs, B, seed=seed).batch_at(step)


def _ref_loss_and_grads(params, ref_cfg, fields, labels):
    loss, grads = jax.value_and_grad(
        lambda p: R.deepfm_loss(p, ref_cfg, jnp.asarray(fields), jnp.asarray(labels)))(params)
    return float(loss), jax.tree.map(np.asarray, grads)


def _assert_params_close(got: dict, want_numpy_tree, tol, what):
    want = M.deepfm_params_from_numpy(want_numpy_tree)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=tol, atol=tol,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_matches_reference(name):
    model, params, cfg, ref_cfg = _pair(name)
    fields, labels = _batch(cfg, 64, 0)
    with torch.no_grad():
        got = M.deepfm_loss(model, torch.from_numpy(fields), torch.from_numpy(labels))
    want = float(R.deepfm_loss(params, ref_cfg, jnp.asarray(fields), jnp.asarray(labels)))
    assert got.shape == () and got.dtype == torch.float32
    assert abs(float(got) - want) <= LOSS_TOL


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_gradients_match_jax_grad(name):
    model, params, cfg, ref_cfg = _pair(name)
    fields, labels = _batch(cfg, 64, 0)
    loss, grads = C.loss_and_grads(model, C.train_params(model), torch.from_numpy(fields),
                                   torch.from_numpy(labels))
    want_loss, want = _ref_loss_and_grads(params, ref_cfg, fields, labels)
    assert abs(float(loss) - want_loss) <= LOSS_TOL
    want = M.deepfm_params_from_numpy(want)
    assert sorted(grads) == sorted(want)
    for k in want:
        assert grads[k].shape == want[k].shape, k
        np.testing.assert_allclose(grads[k].numpy(), want[k].numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
    # untouched rows get exactly 0, as XLA's scatter-add gives them
    touched = np.zeros(cfg.total_vocab, bool)
    touched[(fields + cfg.offsets.numpy()[None, :]).reshape(-1)] = True
    assert not grads["embed"][torch.from_numpy(~touched)].any()
    assert not grads["linear"][torch.from_numpy(~touched)].any()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_one_adamw_update_matches_reference(name):
    """Carried gradients, moments after one reference step, one update each."""
    model, params, cfg, ref_cfg = _pair(name)
    ref_opt_cfg = RO.OptConfig()
    opt_cfg = O.OptConfig()
    f0, l0 = _batch(cfg, 64, 0)
    _, g0 = _ref_loss_and_grads(params, ref_cfg, f0, l0)
    p1, s1, _ = RO.adamw_update(ref_opt_cfg, g0, RO.adamw_init(params), params)
    p1, s1 = jax.tree.map(np.asarray, (p1, s1))
    f1, l1 = _batch(cfg, 64, 1)
    _, g1 = _ref_loss_and_grads(p1, ref_cfg, f1, l1)
    want_p, want_s, want_m = RO.adamw_update(ref_opt_cfg, g1, s1, p1)

    got_p, got_s, got_m = O.adamw_update(
        opt_cfg, M.deepfm_params_from_numpy(g1),
        O.adamw_state_from_numpy(s1, M.deepfm_params_from_numpy, device="cpu"),
        M.deepfm_params_from_numpy(p1))
    _assert_params_close(got_p, jax.tree.map(np.asarray, want_p), UPDATE_TOL, "params")
    _assert_params_close(got_s.m, jax.tree.map(np.asarray, want_s.m), UPDATE_TOL, "m")
    _assert_params_close(got_s.v, jax.tree.map(np.asarray, want_s.v), UPDATE_TOL, "v")
    assert int(got_s.step) == int(want_s.step) == 2 and got_s.step.dtype == torch.int32
    for key in ("grad_norm", "lr"):
        assert abs(float(got_m[key]) - float(want_m[key])) <= UPDATE_TOL * max(
            1.0, abs(float(want_m[key]))), key


@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_ten_train_steps_match_reference(name, opt):
    model, params, cfg, ref_cfg = _pair(name)
    ref_opt_cfg, opt_cfg = RO.OptConfig(**OPTS[opt]), O.OptConfig(**OPTS[opt])

    @jax.jit
    def ref_step(params, opt_state, fields, labels):
        loss, grads = jax.value_and_grad(
            lambda p: R.deepfm_loss(p, ref_cfg, fields, labels))(params)
        params, opt_state, _ = RO.adamw_update(ref_opt_cfg, grads, opt_state, params)
        return params, opt_state, loss

    ref_p, ref_s = params, RO.adamw_init(params)
    p, s = C.train_params(model), O.adamw_init(C.train_params(model))
    stream = ClickStream(cfg.field_vocabs, 128, seed=0)
    for step in range(10):
        fields, labels = stream.batch_at(step)
        ref_p, ref_s, ref_loss = ref_step(ref_p, ref_s, jnp.asarray(fields), jnp.asarray(labels))
        p, s, loss = C.train_step(model, p, s, torch.from_numpy(fields),
                                  torch.from_numpy(labels), opt_cfg=opt_cfg)
        assert abs(float(loss) - float(ref_loss)) <= STEPS_TOL, step
    _assert_params_close(s.m, jax.tree.map(np.asarray, ref_s.m), STEPS_TOL, "m")
    _assert_params_close(s.v, jax.tree.map(np.asarray, ref_s.v), STEPS_TOL, "v")
    assert int(s.step) == 10
    want_p = M.deepfm_params_from_numpy(jax.tree.map(np.asarray, ref_p))
    want_v = M.deepfm_params_from_numpy(jax.tree.map(np.asarray, ref_s.v))
    held = 0
    for k, want in want_p.items():
        v = want_v[k]
        ok = (torch.sqrt(v / (1 - ref_opt_cfg.b2 ** 10)) >= WELL_CONDITIONED) | (v == 0)
        held += int(ok.sum())
        np.testing.assert_allclose(p[k][ok].numpy(), want[ok].numpy(), rtol=STEPS_TOL,
                                   atol=STEPS_TOL, err_msg=f"params {k}")
    assert held >= 0.95 * sum(w.numel() for w in want_p.values())


def test_training_reduces_loss():
    """tests/test_recsys.py::test_training_reduces_loss on the port."""
    cfg = M.DeepFMConfig(field_vocabs=tuple([32] * 10), embed_dim=8, mlp_dims=(32,))
    model = M.DeepFM(cfg, seed=0, device="cpu")
    params = C.train_params(model)
    opt = O.adamw_init(params)
    opt_cfg = O.OptConfig(**RECSYS_OPT)
    stream = ClickStream(cfg.field_vocabs, batch=256, seed=0)
    losses = []
    for i in range(60):
        f, l = stream.batch_at(i)
        params, opt, loss = C.train_step(model, params, opt, torch.from_numpy(f),
                                         torch.from_numpy(l), opt_cfg=opt_cfg)
        losses.append(float(loss))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.01, losses[::10]


def test_train_step_defaults_follow_the_reference_cell():
    """src/repro/configs/deepfm.py:69: OptConfig(total_steps=10000)."""
    import dataclasses

    assert dataclasses.asdict(C.TRAIN_OPT) == dataclasses.asdict(RO.OptConfig(total_steps=10000))


def test_train_step_through_plain_bags_equals_the_wrapper_on_cpu():
    """`bag=embedding_bag_plain` runs both plain versions (what
    chip_smoke.py holds the card's step against); on the CPU the wrapper
    runs them too, so the steps are equal."""
    model, _, cfg, _ = _pair("smoke")
    fields, labels = (torch.from_numpy(a) for a in _batch(cfg, 32, 0))
    params = C.train_params(model)
    opt = O.adamw_init(params)
    a = C.train_step(model, params, opt, fields, labels)
    b = C.train_step(model, params, opt, fields, labels, bag=E.embedding_bag_plain)
    for x, y in zip(jax.tree.leaves((a[0], a[1].m, a[1].v, a[2])),
                    jax.tree.leaves((b[0], b[1].m, b[1].v, b[2]))):
        assert torch.equal(x, y)


def test_train_step_is_out_of_place():
    model, _, cfg, _ = _pair("smoke")
    fields, labels = (torch.from_numpy(a) for a in _batch(cfg, 16, 0))
    params = C.train_params(model)
    before = {k: v.clone() for k, v in params.items()}
    opt = O.adamw_init(params)
    new, new_opt, _ = C.train_step(model, params, opt, fields, labels)
    assert all(torch.equal(params[k], before[k]) for k in params)
    assert not opt.m["embed"].any() and int(opt.step) == 0
    assert int(new_opt.step) == 1 and not torch.equal(new["embed"], before["embed"])


def test_adamw_state_carry():
    _, params, _, _ = _pair("smoke")
    state = jax.tree.map(np.asarray, RO.adamw_init(params))
    state = state._replace(m=jax.tree.map(lambda x: x + 1.0, state.m))
    got = O.adamw_state_from_numpy(state, M.deepfm_params_from_numpy, device="cpu")
    assert got.step.dtype == torch.int32 and int(got.step) == 0
    want = M.deepfm_params_from_numpy(state.m)
    assert all(torch.equal(got.m[k], want[k]) for k in want)
    ws = state.m["mlp"].ws
    assert got.m["mlp.layers.0.weight"].shape == ws[0].T.shape


# --------------------------------------------------------------------------
# the bag's backward against jax.grad of the reference oracle
# --------------------------------------------------------------------------

def _bag_case(B, K, D, V, weights, seed):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, D)).astype(np.float32)
    idx = rng.integers(0, V, (B, K)).astype(np.int32)
    if B:
        idx[:, -1] = idx[:, 0]                       # a duplicate in every bag
    w = None
    if weights == "random":
        w = rng.random((B, K)).astype(np.float32)
    elif weights == "zeros":
        w = rng.random((B, K)).astype(np.float32)
        w[:, ::2] = 0.0                              # masked slots
    g = rng.standard_normal((B, D)).astype(np.float32)
    return table, idx, w, g


def _jax_table_grad(table, idx, w, g):
    ww = np.ones(idx.shape, np.float32) if w is None else w
    _, vjp = jax.vjp(lambda t: embedding_bag_ref(t, jnp.asarray(idx), jnp.asarray(ww)),
                     jnp.asarray(table))
    return np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("weights", ["none", "random", "zeros"])
@pytest.mark.parametrize("B,K,D,V", [(16, 5, 10, 40), (32, 39, 1, 64), (8, 39, 10, 16),
                                     (0, 39, 10, 50), (12, 1, 3, 7)])
def test_bag_backward_matches_jax_grad(B, K, D, V, weights):
    table, idx, w, g = _bag_case(B, K, D, V, weights, seed=B + K + D)
    want = _jax_table_grad(table, idx, w, g)
    wt = None if w is None else torch.from_numpy(w)
    plain = E.embedding_bag_backward_plain(torch.from_numpy(g), torch.from_numpy(idx), wt, V)
    assert plain.shape == (V, D) and plain.dtype == torch.float32
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-5, atol=1e-6)
    # through autograd: the wrapper's Function takes the same backward
    t = torch.from_numpy(table).requires_grad_()
    out = E.embedding_bag(t, torch.from_numpy(idx), wt)
    (got,) = torch.autograd.grad(out, t, torch.from_numpy(g))
    assert torch.equal(got, plain)
    assert torch.equal(E.embedding_bag_backward(torch.from_numpy(g), torch.from_numpy(idx),
                                                wt, V), plain)


def test_bag_backward_sums_each_row_in_the_kernels_order():
    """The plain backward's order, which the kernel follows: the slots, in
    flat order b·K + k, stably sorted by row, cut at every multiple of
    SEGMENT of the sorted position and where the row changes; each piece
    summed from 0 (each product and add rounded once), then each row's
    pieces summed in order from 0."""
    rng = np.random.default_rng(5)
    B, K, D = 25, 3, 2
    idx = torch.full((B, K), 2, dtype=torch.int32)
    idx[:2, :] = 1
    idx[0, 0] = idx[1, 2] = 0                 # row 0: 2 slots, row 1: 4, row 2: 69
    w = torch.from_numpy(rng.random((B, K)).astype(np.float32))
    g = torch.from_numpy((rng.standard_normal((B, D)) * 10.0 ** rng.integers(-3, 4, (B, 1)))
                         .astype(np.float32))
    slots = sorted(range(B * K), key=lambda s: (int(idx.view(-1)[s]), s))
    want = torch.zeros((4, D))
    piece, prev = torch.zeros(D), None
    for at, s in enumerate(slots + [None]):
        row = None if s is None else int(idx.view(-1)[s])
        if at and (row != prev or at % E.SEGMENT == 0):
            want[prev] = want[prev] + piece
            piece = torch.zeros(D)
        if s is not None:
            piece = piece + w.view(-1)[s] * g[s // K]
        prev = row
    got = E.embedding_bag_backward_plain(g, idx, w, 4)
    assert torch.equal(got, want) and not got[3].any()


@pytest.mark.parametrize("weighted", [False, True])
def test_bag_backward_adds_the_gather_term_in_the_kernels_order(weighted):
    """With the gradient `extra` (B, K, D) of a gather table[idx], each
    slot's term is w · g[b] + extra[b, k] (unweighted g[b] + extra[b, k]),
    each operation rounded once, summed in the order above.  The gather
    terms span six decades, so another order or an FMA shows in the bits."""
    rng = np.random.default_rng(7)
    B, K, D = 25, 3, 2
    idx = torch.full((B, K), 2, dtype=torch.int32)
    idx[:2, :] = 1
    idx[0, 0] = idx[1, 2] = 0                 # row 0: 2 slots, row 1: 4, row 2: 69
    w = torch.from_numpy(rng.random((B, K)).astype(np.float32)) if weighted else None
    g = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
    x = torch.from_numpy((rng.standard_normal((B, K, D))
                          * 10.0 ** rng.integers(-3, 4, (B, K, 1))).astype(np.float32))
    slots = sorted(range(B * K), key=lambda s: (int(idx.view(-1)[s]), s))
    want = torch.zeros((4, D))
    piece, prev = torch.zeros(D), None
    for at, s in enumerate(slots + [None]):
        row = None if s is None else int(idx.view(-1)[s])
        if at and (row != prev or at % E.SEGMENT == 0):
            want[prev] = want[prev] + piece
            piece = torch.zeros(D)
        if s is not None:
            term = g[s // K] if w is None else w.view(-1)[s] * g[s // K]
            piece = piece + (term + x.view(-1, D)[s])
        prev = row
    got = E.embedding_bag_backward_plain(g, idx, w, 4, extra=x)
    assert torch.equal(got, want) and not got[3].any()
    assert torch.equal(E.embedding_bag_backward(g, idx, w, 4, extra=x), want)


def _jax_bag_and_gather_grad(table, idx, w, g, gx):
    ww = np.ones(idx.shape, np.float32) if w is None else w
    _, vjp = jax.vjp(lambda t: (embedding_bag_ref(t, jnp.asarray(idx), jnp.asarray(ww)),
                                t[jnp.asarray(idx)]), jnp.asarray(table))
    return np.asarray(vjp((jnp.asarray(g), jnp.asarray(gx)))[0])


@pytest.mark.parametrize("weights", ["none", "random", "zeros"])
@pytest.mark.parametrize("B,K,D,V", [(16, 5, 10, 40), (32, 39, 1, 64), (8, 39, 10, 16),
                                     (0, 39, 10, 50), (12, 1, 3, 7)])
def test_bag_with_gather_backward_matches_jax_grad(B, K, D, V, weights):
    """One backward for the bag sum and the gathered rows table[idx] (the
    `extra` term) against jax.vjp of both outputs, within the same 1e-5
    relative as the bag alone (per-row sums of the same f32 terms in
    another order); through autograd it equals the plain backward."""
    table, idx, w, g = _bag_case(B, K, D, V, weights, seed=B + K + D)
    gx = np.random.default_rng(B + K).standard_normal((B, K, D)).astype(np.float32)
    want = _jax_bag_and_gather_grad(table, idx, w, g, gx)
    wt = None if w is None else torch.from_numpy(w)
    ti, tg, tx = torch.from_numpy(idx), torch.from_numpy(g), torch.from_numpy(gx)
    plain = E.embedding_bag_backward_plain(tg, ti, wt, V, extra=tx)
    assert plain.shape == (V, D) and plain.dtype == torch.float32
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-5, atol=1e-6)
    t = torch.from_numpy(table).requires_grad_()
    out, rows = E.embedding_bag(t, ti, wt, gather=True)
    assert torch.equal(rows, t.detach()[ti.long()])
    (got,) = torch.autograd.grad((out, rows), t, (tg, tx))
    assert torch.equal(got, plain)
    plan = E.SlotPlan(ti, V)
    assert torch.equal(E.embedding_bag_backward(tg, ti, wt, V, extra=tx,
                                                slots=plan.sorted()), plain)


@pytest.mark.parametrize("B,K,V", [(25, 3, 4), (64, 39, 300), (0, 39, 10), (7, 1, 1)])
def test_sort_slots_plain_is_a_stable_sort_with_its_runs(B, K, V):
    """The slot plan: rows sorted, slots in slot order within a row, and
    the runs of equal rows with their first positions, `starts[n_runs]`
    the slot count; `sort_slots` on CPU tensors is the plain version."""
    idx = np.random.default_rng(B + K).integers(0, V, (B, K)).astype(np.int32)
    slots = E.sort_slots(torch.from_numpy(idx), V)
    n = B * K
    order = np.argsort(idx.reshape(-1), kind="stable")
    assert np.array_equal(slots.order.numpy(), order)
    assert np.array_equal(slots.rows.numpy(), idx.reshape(-1)[order])
    uniq, first = np.unique(idx.reshape(-1)[order], return_index=True)
    n_runs = int(slots.n_runs)
    assert n_runs == uniq.size
    assert np.array_equal(slots.run_rows.numpy()[:n_runs], uniq)
    assert np.array_equal(slots.starts.numpy()[:n_runs + 1], np.append(first, n))
    assert all(t.dtype == torch.int32 for t in (slots.rows, slots.order, slots.run_rows,
                                                slots.starts, slots.n_runs))
    assert (slots.rows.shape, slots.starts.shape, slots.n_runs.shape) == ((n,), (n + 1,), (1,))


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("B", [64, 512])
def test_table_gradients_match_jax_grad(name, B):
    """`loss_and_grads`' `embed` and `linear` gradients, now one backward
    launch each (the gather's gradient in the embed launch), against
    jax.grad of the reference's `deepfm_loss`.  At B = 512 the skewed
    config's small fields give rows of hundreds of slots, so segments and
    runs both cut.  Tolerance allclose(rtol=1e-5, atol=1e-7): each row is
    a sum of up to B·F f32 terms, here in the kernel's segment order, in
    XLA's scatter-add order there; the terms themselves (g_v + g_s per
    slot) are one rounding in both."""
    model, params, cfg, ref_cfg = _pair(name)
    fields, labels = _batch(cfg, B, 3)
    _, grads = C.loss_and_grads(model, C.train_params(model), torch.from_numpy(fields),
                                torch.from_numpy(labels))
    _, want = _ref_loss_and_grads(params, ref_cfg, fields, labels)
    for k in ("embed", "linear"):
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(want[k]), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("bag, sorter", [(E.embedding_bag, "sort_slots"),
                                         (E.embedding_bag_plain, "sort_slots_plain")])
def test_one_sort_per_loss_and_grads(monkeypatch, bag, sorter):
    """Both backward launches of a step (linear's D = 1, embed's D = d with
    the gather term) share one slot plan: its sort runs once per
    `loss_and_grads`, and not at all in a forward without gradients."""
    model, _, cfg, _ = _pair("smoke")
    fields, labels = (torch.from_numpy(a) for a in _batch(cfg, 32, 0))
    made = []
    sort = getattr(E, sorter)
    monkeypatch.setattr(E, sorter, lambda *a: made.append(a[0].shape) or sort(*a))
    C.loss_and_grads(model, C.train_params(model), fields, labels, bag=bag)
    assert made == [(32, cfg.n_fields)]
    C.loss_and_grads(model, C.train_params(model), fields, labels, bag=bag)
    assert len(made) == 2
    with torch.no_grad():
        M.deepfm_logits(model, fields, bag=bag)
    assert len(made) == 2


def _graph_nodes(fn) -> list:
    seen, todo = [], [fn]
    while todo:
        node = todo.pop()
        if node is None or any(node is x for x in seen):
            continue
        seen.append(node)
        todo.extend(nxt for nxt, _ in node.next_functions)
    return seen


def test_no_index_backward_reaches_the_tables():
    """The step's graph has no IndexBackward0 (whose backward is a dense
    `index_put_` with accumulate): the tables' only parents are the bag's
    Function, one node per table."""
    model, _, cfg, _ = _pair("smoke")
    fields, labels = (torch.from_numpy(a) for a in _batch(cfg, 16, 0))
    leaves = {k: p.detach().requires_grad_() for k, p in C.train_params(model).items()}
    logits = torch.func.functional_call(model, leaves, (fields,))
    nodes = _graph_nodes(M.bce_with_logits(logits, labels).grad_fn)
    names = [type(n).__name__ for n in nodes]
    assert "IndexBackward0" not in names and not any("IndexPut" in x for x in names)
    for table in ("embed", "linear"):
        parents = [n for n in nodes if any(
            getattr(nxt, "variable", None) is leaves[table] for nxt, _ in n.next_functions)]
        if table == "linear":        # linear.view(V, 1)
            assert [type(n).__name__ for n in parents] == ["ViewBackward0"]
            parents = [n for n in nodes if any(nxt is parents[0] for nxt, _ in n.next_functions)]
        assert [type(n).__name__ for n in parents] == ["_BagBackward"], table


def test_slot_plan_refuses_other_indices():
    idx = torch.zeros((3, 2), dtype=torch.int32)
    table = torch.randn((4, 2), requires_grad=True)
    with pytest.raises(ValueError, match="another index tensor"):
        E.embedding_bag(table, idx.clone(), plan=E.SlotPlan(idx, 4))


def test_plain_segment_matches_the_kernel_source():
    import pathlib
    import re

    from repro_torch.hopper import build

    src = (pathlib.Path(build.CSRC) / "embedding_bag.cu").read_text()
    assert re.findall(r"constexpr int kSegment = (\d+);", src) == [str(E.SEGMENT)]


def test_dense_tile_matches_the_kernel_source():
    """`dense_rows` (the tests' and chip_smoke.py's CTA edges) follows
    kTileFloats, and a CTA's rows keep its tile 16-byte aligned."""
    import pathlib
    import re

    from repro_torch.hopper import build

    src = (pathlib.Path(build.CSRC) / "embedding_bag.cu").read_text()
    assert re.findall(r"constexpr int kTileFloats = (\d+);", src) == [str(E.TILE_FLOATS)]
    assert [E.dense_rows(d) for d in (1, 3, 10, 40, 5000)] == [8192, 2728, 816, 204, 4]


def test_bag_refuses_gradients_no_kernel_computes():
    table = torch.randn((10, 4), requires_grad=True)
    idx = torch.zeros((3, 2), dtype=torch.int32)
    w = torch.ones((3, 2), requires_grad=True)
    with pytest.raises(RuntimeError, match="weights"):
        E.embedding_bag(table.detach(), idx, w)
    with pytest.raises(RuntimeError, match="weights"):
        E.embedding_bag_plain(table, idx, w)
    with pytest.raises(RuntimeError, match="f32 tables only"):
        E.embedding_bag(table.detach().bfloat16().requires_grad_(), idx)
    with torch.no_grad():                       # no gradient wanted: no refusal
        E.embedding_bag(table.detach().bfloat16().requires_grad_(), idx, w)
    with torch.inference_mode():
        E.embedding_bag(table, idx, w)
