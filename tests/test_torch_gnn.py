"""The GNN family on the port (`repro_torch.models.gnn`, `configs.gnn_cells`,
the four arch configs, `graphs.sampler`, `GraphBatchStream`) against the
JAX reference: the same numpy inputs and the same weights (drawn by the
reference's `*_init`, carried by `gnn_params_from_numpy`) through both
packages, at small sizes (<= 150 vertices, feature widths <= 16, each
arch's layer count).  The reference's train steps are its own cell
builders' (`_full_graph_cell`, `_minibatch_cell` at a small batch,
`_molecule_cell`), called eagerly on a one-device mesh; its tiled GIN
backend runs the Pallas kernel in interpret mode, as its own tests run it.

Tolerances, all scale-normalised (|port - reference| / max |reference|):
forwards 1e-5 in f32 (the reference's own GIN backend test); gradients
1e-4 leaf for leaf, with equal `isfinite` masks.  The gradient and AdamW
cases run both packages in f64 (the optimizer keeps f32 moments either
way): in f32, PNA's gradients are ill-conditioned (its std is
sqrt(E[m²] − E[m]² + 1e-8)), and the reference's own f32 gradients lie up
to 5e-4 from its f64 ones, as far as the port's do; in f64 the two agree
within 1e-6.  One AdamW step: the moments as the gradients; each parameter
whose gradient is at least 1e-3 of its leaf's largest within 1e-3·lr plus
two f32 ulps of the reference's (the normalised step m̂/√v̂ of a
well-resolved gradient is its sign to within 1e-3), and every other one
within a step, lr·(1 + wd·|p|), of where it was.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from scipy.spatial.transform import Rotation

from repro.configs import egnn as ref_egnn_cfg
from repro.configs import gin_tu as ref_gin_cfg
from repro.configs import gnn_cells as ref_cells
from repro.configs import mace as ref_mace_cfg
from repro.configs import pna as ref_pna_cfg
from repro.core.tiling import build_block_tiles as ref_build_block_tiles
from repro.data.pipeline import GraphBatchStream as RefGraphBatchStream
from repro.graphs import sampler as ref_sampler
from repro.graphs.generators import erdos_renyi as ref_erdos_renyi
from repro.graphs.graph import build_csr as ref_build_csr
from repro.models.gnn import common as ref_common
from repro.models.gnn import egnn as ref_egnn
from repro.models.gnn import gin as ref_gin
from repro.models.gnn import mace as ref_mace
from repro.models.gnn import pna as ref_pna
from repro.train import optimizer as RO
from repro_torch.configs import GNN_ARCHS
from repro_torch.configs import gnn_cells as C
from repro_torch.core import prng
from repro_torch.core.tiling import build_block_tiles
from repro_torch.data.pipeline import GraphBatchStream
from repro_torch.graphs import sampler as S
from repro_torch.graphs.generators import erdos_renyi
from repro_torch.graphs.graph import build_csr
from repro_torch.models import gnn as G
from repro_torch.models.gnn import mace as M
from repro_torch.models.gnn.pna import aggregate
from repro_torch.train import optimizer as O

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
D_IN, N_OUT = 8, 4
ARCHS = ("gin-tu", "pna", "egnn", "mace")
SHAPES = ("full_graph_sm", "minibatch_lg", "molecule")
REF_ARCHS = {"gin-tu": ref_gin_cfg.GNN, "pna": ref_pna_cfg.GNN, "egnn": ref_egnn_cfg.GNN,
             "mace": ref_mace_cfg.GNN}
MINI_B, MINI_FANOUT = 8, (4, 3)           # the minibatch cell cut to 8 + 32 + 96 slots
MOL = dict(batch=4, n_nodes=30, n_edges=64, d_feat=D_IN)


# --------------------------------------------------------------------------
# weights and inputs for both packages
# --------------------------------------------------------------------------

def _ref_params(arch, n_out, seed=0):
    """Small-width reference params (each arch's layer count), as numpy."""
    key = jax.random.key(seed)
    if arch == "gin-tu":
        p = ref_gin.gin_init(key, D_IN, d_hidden=16, n_layers=5, n_out=n_out)
    elif arch == "pna":
        p = ref_pna.pna_init(key, D_IN, d_hidden=12, n_layers=4, n_out=n_out)
    elif arch == "egnn":
        p = ref_egnn.egnn_init(key, D_IN, d_hidden=16, n_layers=4, n_out=n_out)
    else:
        p = ref_mace.mace_init(key, D_IN, channels=8, n_layers=2, n_rbf=8)
        if n_out != 1:      # the reference config's classification readout
            p["readout"] = ref_common.mlp_init(jax.random.fold_in(key, 99), (8, 16, n_out))
    return jax.tree.map(np.asarray, p)


def _port_model(arch, n_out, tree):
    if arch == "gin-tu":
        model = G.GIN(D_IN, 16, 5, n_out, device="cpu")
    elif arch == "pna":
        model = G.PNA(D_IN, 12, 4, n_out, device="cpu")
    elif arch == "egnn":
        model = G.EGNN(D_IN, 16, 4, n_out, device="cpu")
    else:
        model = G.MACE(D_IN, channels=8, n_layers=2, n_rbf=8, n_out=n_out, device="cpu")
    model.load_state_dict(G.gnn_params_from_numpy(arch, tree))
    return model


def _pair(arch, n_out, seed=0):
    tree = _ref_params(arch, n_out, seed)
    return tree, _port_model(arch, n_out, tree)


def _graph(n=100, deg=6.0, seed=0):
    """The same ER graph in both packages, masked edges routed to vertex 0
    as the reference's cells route them: (ref graph, port graph, s, r,
    mask) with numpy s, r, mask."""
    ref_g = ref_erdos_renyi(n, avg_deg=deg, seed=seed)
    g = erdos_renyi(n, avg_deg=deg, seed=seed, device="cpu")
    np.testing.assert_array_equal(g.senders.numpy(), np.asarray(ref_g.senders))
    mask = np.asarray(ref_g.edge_mask)
    s = np.where(mask, np.asarray(ref_g.senders), 0).astype(np.int32)
    r = np.where(mask, np.asarray(ref_g.receivers), 0).astype(np.int32)
    return ref_g, g, s, r, mask


def _node_inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, D_IN)).astype(np.float32)
    coords = rng.standard_normal((n, 3)).astype(np.float32)
    labels = rng.integers(0, N_OUT, n).astype(np.int32)
    return feats, coords, labels


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want), err_msg=what)
    fin = np.isfinite(want)
    if not fin.any():
        return
    scale = max(float(np.abs(want[fin]).max()), 1e-30)
    err = float(np.abs(got[fin] - want[fin]).max()) / scale
    assert err <= tol, f"{what}: scale-normalised |err| {err:.3g} > {tol} (scale {scale:.3g})"


def _close_tree(arch, got: dict, want_tree, tol, what):
    want = G.gnn_params_from_numpy(arch, want_tree)
    assert sorted(got) == sorted(want), what
    for k in want:
        _close(got[k].detach().numpy(), want[k].numpy(), tol, f"{what} {k}")


def _mesh():
    return Mesh(np.array(jax.devices()[:1]), ("data",))


# --------------------------------------------------------------------------
# the substrate
# --------------------------------------------------------------------------

def test_segment_ops_follow_jax():
    """segment_sum / max / mean and degrees_from_edges against jax.ops on
    the same ids, including an empty segment (sum 0, max -inf)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((40, 5)).astype(np.float32)
    ids = rng.integers(0, 9, 40).astype(np.int32)
    ids[ids == 4] = 5                                  # segment 4 is empty
    mask = rng.random(40) < 0.7
    xt, it, mt = _t(x, ids, mask)
    np.testing.assert_allclose(G.segment_sum(xt, it, 10).numpy(),
                               np.asarray(jax.ops.segment_sum(x, ids, num_segments=10)),
                               rtol=1e-6, atol=1e-6)
    got = G.segment_max(xt, it, 10).numpy()
    want = np.asarray(jax.ops.segment_max(x, ids, num_segments=10))
    np.testing.assert_array_equal(got, want)
    assert np.isneginf(got[4]).all() and np.isneginf(got[9]).all()
    np.testing.assert_allclose(G.segment_mean(xt, it, 10, mt).numpy(),
                               np.asarray(ref_common.segment_mean(x, ids, 10, mask)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(G.segment_mean(xt, it, 10).numpy(),
                               np.asarray(ref_common.segment_mean(x, ids, 10)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(G.degrees_from_edges(it, mt, 10).numpy(),
                                  np.asarray(ref_common.degrees_from_edges(ids, mask, 10)))
    h = rng.standard_normal((9, 3)).astype(np.float32)
    snd = rng.integers(0, 9, 40).astype(np.int32)
    np.testing.assert_allclose(
        G.gather_scatter_sum(*_t(h, snd, ids, mask), 9).numpy(),
        np.asarray(ref_common.gather_scatter_sum(h, snd, ids, mask, 9)), rtol=1e-6, atol=1e-6)


def test_segment_max_splits_tied_gradients_as_jax():
    x = np.array([[1.0], [3.0], [3.0], [2.0]], np.float32)
    ids = np.array([0, 0, 0, 1], np.int32)
    want = np.asarray(jax.grad(lambda v: jax.ops.segment_max(v, ids, num_segments=3)[:2].sum())(x))
    xt = torch.from_numpy(x).requires_grad_()
    G.segment_max(xt, torch.from_numpy(ids), 3)[:2].sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), want)


@pytest.mark.parametrize("act", ["default", "relu"])
def test_mlp_defaults_to_silu_as_mlp_apply(act):
    """The port's MLP applies SiLU between layers by default (the
    reference's `mlp_apply`) and the `act` it is given otherwise, as DeepFM
    passes ReLU (tests/test_torch_deepfm.py holds its forward to the
    reference's); nothing after the last layer."""
    tree = jax.tree.map(np.asarray, ref_common.mlp_init(jax.random.key(0), (6, 7, 5)))
    kw, ref_kw = ({}, {}) if act == "default" else ({"act": torch.relu}, {"act": jax.nn.relu})
    mlp = G.MLP((6, 7, 5), key=prng.key(0), device="cpu", **kw)
    mlp.load_state_dict(_mlp_state(tree))
    x = np.random.default_rng(1).standard_normal((11, 6)).astype(np.float32)
    want = np.asarray(ref_common.mlp_apply(tree, x, **ref_kw))
    np.testing.assert_allclose(mlp(torch.from_numpy(x)).detach().numpy(), want,
                               rtol=1e-5, atol=1e-6)


def _mlp_state(tree):
    """The reference's MLP(ws, bs) as an `MLP` state dict."""
    state = {}
    for i, (w, b) in enumerate(zip(tree.ws, tree.bs)):
        state[f"layers.{i}.weight"] = torch.from_numpy(np.ascontiguousarray(w.T))
        state[f"layers.{i}.bias"] = torch.from_numpy(b)
    return state


def test_gnn_params_from_numpy_refuses_a_wrong_tree():
    tree = _ref_params("gin-tu", N_OUT)
    with pytest.raises(ValueError, match="unknown GNN arch"):
        G.gnn_params_from_numpy("gcn", tree)
    with pytest.raises(ValueError, match="expected"):
        G.gnn_params_from_numpy("mace", tree)


def test_coupling_tensors_equal_the_reference():
    """The list fixes the radial layout and the rows of w_b2 / w_b3: the
    same (l1, l2, l3) in the same order, each K within 1e-6."""
    got, want = M.coupling_tensors(), ref_mace.coupling_tensors()
    assert [p[:3] for p in got] == [p[:3] for p in want]
    for (*ls, K), (*_, Kr) in zip(got, want):
        assert K.dtype == np.float32 and K.shape == Kr.shape, ls
        np.testing.assert_allclose(K, Kr, rtol=0, atol=1e-6, err_msg=str(ls))
    units = np.random.default_rng(0).standard_normal((7, 3)).astype(np.float32)
    units /= np.linalg.norm(units, axis=1, keepdims=True)
    ref_Y = ref_mace.real_sph_harm(jnp.asarray(units))
    for l, y in M.real_sph_harm(torch.from_numpy(units)).items():
        np.testing.assert_allclose(y.numpy(), np.asarray(ref_Y[l]), rtol=1e-6, atol=1e-7)
    r = np.linspace(0.0, 6.0, 13).astype(np.float32)
    np.testing.assert_allclose(M.bessel_rbf(torch.from_numpy(r), 8, 5.0).numpy(),
                               np.asarray(ref_mace.bessel_rbf(jnp.asarray(r), 8, 5.0)),
                               rtol=1e-5, atol=1e-6)


def test_pna_aggregators():
    """The reference's hand check on a tiny star graph: edges 0->2, 1->2
    with messages [1, 3]."""
    m = torch.tensor([[1.0], [3.0]])
    recv = torch.tensor([2, 2], dtype=torch.int32)
    mask = torch.tensor([True, True])
    mean, mx, mn, std, cnt = aggregate(m, recv, mask, 3)
    np.testing.assert_allclose(float(mean[2, 0]), 2.0)
    np.testing.assert_allclose(float(mx[2, 0]), 3.0)
    np.testing.assert_allclose(float(mn[2, 0]), 1.0)
    np.testing.assert_allclose(float(std[2, 0]), 1.0, rtol=1e-3)
    assert float(cnt[0]) == 0.0 and float(mx[0, 0]) == 0.0  # isolated node neutral


# --------------------------------------------------------------------------
# forwards
# --------------------------------------------------------------------------

def _ref_forward(arch, tree, feats, coords, s, r, mask):
    """The reference's apply, as a flat list of numpy outputs: op by op,
    but MACE's, jitted for time (XLA's fused f32 PNA forward lies 1e-4
    from its f64 forward, the op-by-op one within 3e-6: PNA's std,
    sqrt(E[m²] − E[m]² + 1e-8), is ill-conditioned in f32)."""
    if arch == "gin-tu":
        return [np.asarray(x) for x in ref_gin.gin_apply(tree, feats, s, r, mask)]
    if arch == "pna":
        return [np.asarray(x) for x in ref_pna.pna_apply(tree, feats, s, r, mask)]
    if arch == "egnn":
        return [np.asarray(x) for x in ref_egnn.egnn_apply(tree, feats, coords, s, r, mask)]
    h, e = jax.jit(ref_mace.mace_apply)(tree, feats, coords, s, r, mask)
    return [np.asarray(h[l]) for l in range(3)] + [np.asarray(e)]


def _port_forward(arch, model, feats, coords, s, r, mask):
    with torch.no_grad():
        if arch in ("gin-tu", "pna"):
            return [x.numpy() for x in model(feats, s, r, mask)]
        if arch == "egnn":
            h, x, out = model(feats, coords, s, r, mask)
            return [h.numpy(), x.numpy(), out.sum().numpy()]
        h, out = model(feats, coords, s, r, mask)
        return [h[l].numpy() for l in range(3)] + [out.sum().numpy()]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_the_reference(arch):
    """Each arch's forward with the reference's weights on one graph; the
    energy archs at n_out = 1 (their energy readout)."""
    n_out = 1 if arch in ("egnn", "mace") else N_OUT
    tree, model = _pair(arch, n_out)
    _, _, s, r, mask = _graph(n=100, seed=1)
    feats, coords, _ = _node_inputs(100, seed=1)
    coords = coords * 0.8 if arch == "mace" else coords
    want = _ref_forward(arch, tree, feats, coords, s, r, mask)
    got = _port_forward(arch, model, *_t(feats, coords, s, r, mask))
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, FWD_TOL, f"{arch} output {i}")


def test_pna_delta_is_taken_per_graph():
    """A block-diagonal batch of molecules through PNA equals each molecule
    on its own (δ per molecule), as the reference's vmap computes."""
    tree, model = _pair("pna", N_OUT)
    feats, coords, snd, rcv, mask, _ = GraphBatchStream(seed=3, **MOL).batch_at(0)
    a = GNN_ARCHS["pna"]
    got = C.molecule_energies(a, model, None, *_t(feats, coords, snd, rcv, mask))
    want = [float(ref_pna_cfg.GNN.graph_energy(tree, feats[b], coords[b], snd[b], rcv[b],
                                               mask[b])) for b in range(MOL["batch"])]
    _close(got.detach().numpy(), want, FWD_TOL, "per-molecule energies")


# --------------------------------------------------------------------------
# GIN's tiled backend
# --------------------------------------------------------------------------

def _gin_tiled_case(T, seed=5):
    tree, model = _pair("gin-tu", N_OUT)
    ref_g, g, s, r, mask = _graph(n=150, deg=8.0, seed=seed)
    ref_t = ref_build_block_tiles(ref_g, tile_size=T)
    tiled = build_block_tiles(g, tile_size=T)
    # the reference's split Pallas kernel leaves a block-row with no tile
    # unwritten: the case covers every block-row
    assert bool((tiled.row_starts[1:] > tiled.row_starts[:-1]).all())
    feats, _, _ = _node_inputs(150, seed=seed)
    return tree, model, ref_t, tiled, feats, s, r, mask


@pytest.mark.parametrize("T", [16, 32])
def test_gin_tiled_matches_the_reference_pallas_and_segment(T):
    """The port's tiled GIN (the split SpMV's plain version on the CPU)
    against the reference's on its interpret-mode Pallas kernel, and
    against the port's own segment backend."""
    tree, model, ref_t, tiled, feats, s, r, mask = _gin_tiled_case(T)
    want_h, want_out = ref_gin.gin_apply(tree, feats, s, r, mask, tiled=ref_t, backend="tiled")
    args = _t(feats, s, r, mask)
    with torch.no_grad():
        h, out = model(*args, tiled=tiled, backend="tiled")
        h_seg, out_seg = model(*args)
    _close(h.numpy(), np.asarray(want_h), FWD_TOL, "tiled h vs the reference's")
    _close(out.numpy(), np.asarray(want_out), FWD_TOL, "tiled head vs the reference's")
    _close(h.numpy(), h_seg.numpy(), FWD_TOL, "tiled h vs segment")
    _close(out.numpy(), out_seg.numpy(), FWD_TOL, "tiled head vs segment")


def test_gin_tiled_refuses_to_differentiate():
    """The kernel launch has no gradient (nor has the reference's Pallas
    backend): with grad enabled and a hidden state that needs one, the
    tiled backend raises instead of returning a detached result."""
    _, model, _, tiled, feats, s, r, mask = _gin_tiled_case(16)
    args = _t(feats, s, r, mask)
    with pytest.raises(RuntimeError, match="no gradient"):
        model(*args, tiled=tiled, backend="tiled")
    with pytest.raises(ValueError, match="tiling"):
        model(*args, backend="tiled")
    with pytest.raises(ValueError, match="unknown backend"):
        model(*args, backend="pallas")
    with torch.no_grad():
        model(*args, tiled=tiled, backend="tiled")


# --------------------------------------------------------------------------
# the cells: gradients and one AdamW step
# --------------------------------------------------------------------------

def _cell_inputs(shape, seed=0):
    """(numpy inputs of the port's loss, numpy inputs of the reference's
    step, PRNG key or None)."""
    if shape == "full_graph_sm":
        _, _, s, r, mask = _graph(n=100, seed=seed)
        feats, coords, labels = _node_inputs(100, seed=seed)
        args = (feats, coords, s, r, mask, labels)
        return args, args, None
    if shape == "molecule":
        feats, coords, snd, rcv, mask, energy = GraphBatchStream(seed=seed, **MOL).batch_at(0)
        args = (feats, coords, snd, rcv, mask, energy)
        return args, args, None
    ref_g, _, _, _, _ = _graph(n=150, deg=5.0, seed=seed)
    indptr, indices = ref_build_csr(ref_g)
    feats, coords, labels = _node_inputs(150, seed=seed)
    coords[:, 0] = np.arange(150)          # a gathered row names its vertex
    seeds = np.random.default_rng(seed).choice(150, MINI_B, replace=False).astype(np.int32)
    key = jax.random.key(seed)
    ref_args = (indptr.astype(np.int32), indices, feats, coords, labels, seeds)
    return (indptr, indices, feats, coords, labels, seeds), ref_args, key


def _ref_minibatch_draws(key):
    """The reference cell's draws: split the key, one randint per hop."""
    k1, k2 = jax.random.split(key)
    hi = jnp.iinfo(jnp.int32).max
    B, (f1, f2) = MINI_B, MINI_FANOUT
    return (np.asarray(jax.random.randint(k1, (B, f1), 0, hi, dtype=jnp.int32)),
            np.asarray(jax.random.randint(k2, (B, f1, f2), 0, hi, dtype=jnp.int32)))


@pytest.fixture
def small_minibatch_cell(monkeypatch):
    shape = dict(ref_cells.GNN_SHAPES["minibatch_lg"], batch_nodes=MINI_B, fanout=MINI_FANOUT)
    monkeypatch.setitem(ref_cells.GNN_SHAPES, "minibatch_lg", shape)


def _ref_step(ref_a, shape):
    if shape == "full_graph_sm":
        return ref_cells._full_graph_cell(ref_a, shape).build(_mesh())[0]
    if shape == "molecule":
        return ref_cells._molecule_cell(ref_a).build(_mesh())[0]
    return ref_cells._minibatch_cell(ref_a).build(_mesh())[0]


def _ref_loss_fn(ref_a, shape, ref_args, captured):
    """The reference cell's loss of the params; for the minibatch cell on
    the tree its step sampled (captured from its node_logits call)."""
    if shape == "full_graph_sm":
        feats, coords, s, r, mask, labels = ref_args
        return lambda p: ref_cells._xent(ref_a.node_logits(p, feats, coords, s, r, mask), labels)
    if shape == "molecule":
        feats, coords, s, r, mask, energy = ref_args

        def loss(p):
            e = jax.vmap(lambda f, c, sd, rc, mk: ref_a.graph_energy(p, f, c, sd, rc, mk))(
                feats, coords, s, r, mask)
            return jnp.mean((e - energy) ** 2)
        return loss
    labels, seeds = ref_args[4], ref_args[5]
    feats, coords, snd, rcv, emask = captured["tree"]
    return lambda p: ref_cells._xent(
        ref_a.node_logits(p, feats, coords, snd, rcv, emask)[:MINI_B], labels[seeds])


def _as(dtype, arrays):
    """The float32 arrays among `arrays` as `dtype`, the others as they are."""
    return tuple(x.astype(dtype) if np.asarray(x).dtype == np.float32 else x for x in arrays)


@functools.lru_cache(maxsize=None)
def _run_both(arch, shape, dtype=np.float32):
    """One step of the reference's cell and the port's loss, gradients and
    step on the same weights and inputs, in `dtype` in both packages (the
    optimizer keeps its moments in f32 either way)."""
    n_out = 1 if shape == "molecule" else N_OUT
    tree, model = _pair(arch, n_out)
    tree = jax.tree.map(lambda x: x.astype(dtype), tree)
    model = model.to({np.float32: torch.float32, np.float64: torch.float64}[dtype])
    args, ref_args, key = _cell_inputs(shape)
    args, ref_args = _as(dtype, args), _as(dtype, ref_args)
    captured = {}

    def capture(p, *tree_args):
        jax.debug.callback(lambda *xs: captured.update(tree=tuple(map(np.asarray, xs))),
                           *tree_args)
        return REF_ARCHS[arch].node_logits(p, *tree_args)

    with jax.enable_x64(dtype == np.float64):
        ref_a = dataclasses.replace(REF_ARCHS[arch], node_logits=capture)
        step = jax.jit(_ref_step(ref_a, shape))
        ref_opt = RO.adamw_init(tree)
        if shape == "minibatch_lg":
            draws = _t(*_ref_minibatch_draws(key))
            ref_new, ref_new_opt, ref_loss = step(tree, ref_opt, jax.random.key_data(key),
                                                  *ref_args)
        else:
            ref_new, ref_new_opt, ref_loss = step(tree, ref_opt, *ref_args)
        jax.effects_barrier()
        ref_grads = jax.jit(jax.grad(_ref_loss_fn(REF_ARCHS[arch], shape, ref_args,
                                                  captured)))(tree)
        ref_grads, ref_new = (jax.tree.map(np.asarray, x) for x in (ref_grads, ref_new))
        ref_new_opt = jax.tree.map(np.asarray, ref_new_opt)

    a = GNN_ARCHS[arch]
    params = C.train_params(model)
    opt = O.adamw_init(params)
    t = _t(*args)
    if shape == "full_graph_sm":
        loss_fn = lambda p: C.full_graph_loss(a, model, p, *t)             # noqa: E731
        new, new_opt, loss = C.full_graph_step(a, model, params, opt, *t)
    elif shape == "molecule":
        loss_fn = lambda p: C.molecule_loss(a, model, p, *t)               # noqa: E731
        new, new_opt, loss = C.molecule_step(a, model, params, opt, *t)
    else:
        indptr, indices, feats, coords, labels, seeds = t
        pkey = prng.Key(*(int(w) for w in jax.random.key_data(key)))
        port_draws = C.minibatch_draws(pkey, MINI_B, MINI_FANOUT, "cpu")
        for u, v in zip(port_draws, draws):
            assert torch.equal(u, v)
        tree_port = C.minibatch_tree(indptr, indices, seeds, port_draws)
        loss_fn = lambda p: C.minibatch_loss(a, model, p, tree_port, feats, coords,  # noqa: E731
                                             labels, seeds)
        new, new_opt, loss = C.minibatch_step(a, model, params, opt, port_draws, indptr,
                                              indices, feats, coords, labels, seeds)
        ids, snd, rcv, emask = tree_port
        want = captured["tree"]
        np.testing.assert_array_equal(coords[ids.long()].numpy(), want[1])
        for got_a, want_a in zip((snd, rcv, emask), want[2:]):
            np.testing.assert_array_equal(got_a.numpy(), want_a)
    port_loss, grads = C.loss_and_grads(loss_fn, params)
    return dict(tree=tree, params=params, ref_loss=float(ref_loss), ref_grads=ref_grads,
                ref_new=ref_new, ref_new_opt=ref_new_opt, loss=float(loss),
                port_loss=float(port_loss), grads=grads, new=new, new_opt=new_opt)


CELLS = [(a, s) for a in ARCHS for s in SHAPES]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_gradients_match_jax_grad(arch, shape, small_minibatch_cell):
    """The cell's loss and every gradient leaf against jax.grad of the
    reference cell's loss; the minibatch cell's tree, sampled from the
    reference's draws and by the port from the same key, equal to the one
    its step built."""
    out = _run_both(arch, shape, np.float64)
    assert out["loss"] == out["port_loss"]
    np.testing.assert_allclose(out["loss"], out["ref_loss"], rtol=1e-5)
    _close_tree(arch, out["grads"], out["ref_grads"], GRAD_TOL, f"{arch} {shape} grad")


def test_egnn_molecule_gradients_are_not_finite_as_in_the_reference(small_minibatch_cell):
    """Pinned divergence inside the reference: the molecule batches' masked
    self-loops have ‖x_i − x_j‖ = 0, where sqrt's gradient is infinite,
    and from layer 2 on the coordinates depend on the parameters.  The
    loss is finite; the port's non-finite gradient entries are the
    reference's, leaf for leaf."""
    out = _run_both("egnn", "molecule")
    assert np.isfinite(out["loss"])
    want = G.gnn_params_from_numpy("egnn", out["ref_grads"])
    bad = sorted(k for k, g in want.items() if not bool(torch.isfinite(g).all()))
    assert bad, "the reference's EGNN molecule gradients are finite now"
    for k, g in out["grads"].items():
        np.testing.assert_array_equal(torch.isfinite(g).numpy(), torch.isfinite(want[k]).numpy(),
                                      err_msg=k)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_one_adamw_step_matches_the_reference_cell(arch, shape, small_minibatch_cell):
    """The port's train step against the reference cell's own step (its
    loss, jax.value_and_grad, adamw_update with OptConfig(total_steps=
    1000)): the loss, both moments, the step and every parameter; both
    packages in f64, as for the gradients."""
    out = _run_both(arch, shape, np.float64)
    cfg = C.TRAIN_OPT
    assert cfg == O.OptConfig(total_steps=1000)
    np.testing.assert_allclose(out["loss"], out["ref_loss"], rtol=1e-5)
    opt = out["new_opt"]
    assert int(opt.step) == int(out["ref_new_opt"].step) == 1
    _close_tree(arch, opt.m, out["ref_new_opt"].m, GRAD_TOL, "m")
    _close_tree(arch, opt.v, out["ref_new_opt"].v, GRAD_TOL, "v")
    lr = float(RO.schedule(RO.OptConfig(total_steps=1000), jnp.asarray(1)))
    old = G.gnn_params_from_numpy(arch, out["tree"])
    want = G.gnn_params_from_numpy(arch, out["ref_new"])
    grads = G.gnn_params_from_numpy(arch, out["ref_grads"])
    for k, w in want.items():
        got, w, p, g = out["new"][k].numpy(), w.numpy(), old[k].numpy(), grads[k].numpy()
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(w), err_msg=k)
        if not np.isfinite(w).all():
            continue
        resolved = np.abs(g) >= 1e-3 * np.abs(g).max()
        tol = 1e-3 * lr + 2 * np.spacing(np.abs(w).astype(np.float32)).astype(np.float64)
        assert (np.abs(got - w) <= tol)[resolved].all(), k
        step = lr * (1 + cfg.weight_decay * np.abs(p)) * (1 + 1e-3) + np.spacing(np.abs(p))
        assert (np.abs(got - p) <= step).all(), k


# --------------------------------------------------------------------------
# properties of the port alone
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(2))
def test_egnn_equivariance(seed):
    """tests/test_gnn.py's property on the port: an invariant energy and
    features, coordinates that rotate and translate with the input."""
    _, _, s, r, mask = _graph(seed=seed)
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((100, D_IN)).astype(np.float32)
    coords = rng.standard_normal((100, 3)).astype(np.float32)
    model = G.EGNN(D_IN, seed=seed + 20, device="cpu")
    R = Rotation.random(random_state=seed).as_matrix().astype(np.float32)
    t = np.array([1.0, -2.0, 0.5], np.float32)
    with torch.no_grad():
        h1, x1, o1 = model(*_t(feats, coords, s, r, mask))
        h2, x2, o2 = model(*_t(feats, coords @ R.T + t, s, r, mask))
    np.testing.assert_allclose(float(o1.sum()), float(o2.sum()), rtol=1e-4)
    _close(h2.numpy(), h1.numpy(), 1e-4, "EGNN features")
    np.testing.assert_allclose(x1.numpy() @ R.T + t, x2.numpy(), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("seed", range(2))
def test_mace_invariance_and_l1_equivariance(seed):
    """tests/test_gnn.py's property on the port: an invariant energy and
    l = 0 features; l = 1 features rotate with R in the (y, z, x) basis."""
    _, _, s, r, mask = _graph(n=60, seed=seed)
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((60, D_IN)).astype(np.float32)
    coords = (rng.standard_normal((60, 3)) * 0.8).astype(np.float32)
    model = G.MACE(D_IN, channels=16, seed=seed + 2, device="cpu")
    R = Rotation.random(random_state=seed).as_matrix().astype(np.float32)
    with torch.no_grad():
        h1, o1 = model(*_t(feats, coords, s, r, mask))
        h2, o2 = model(*_t(feats, coords @ R.T + 3.0, s, r, mask))
    np.testing.assert_allclose(float(o1.sum()), float(o2.sum()), rtol=1e-4)
    np.testing.assert_allclose(h1[0].numpy(), h2[0].numpy(), rtol=1e-3, atol=1e-4)
    P = np.zeros((3, 3), np.float32)
    P[0, 1] = P[1, 2] = P[2, 0] = 1
    rotated = np.einsum("ij,njc->nic", P @ R @ P.T, h1[1].numpy())
    np.testing.assert_allclose(rotated, h2[1].numpy(), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_gnn_smoke_runs_on_cpu(arch):
    C.gnn_smoke(GNN_ARCHS[arch], device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_configs_follow_the_reference(arch):
    """GNN_ARCHS by arch id; each config's init at the published widths
    (parameter shapes equal to the reference's init, carried by name) and
    its FLOP count equal to the reference's on every shape."""
    a, ref_a = GNN_ARCHS[arch], REF_ARCHS[arch]
    assert a.arch_id == ref_a.arch_id == arch
    for name, sh in C.GNN_SHAPES.items():
        assert sh == ref_cells.GNN_SHAPES[name]
        n, e, d = sh["n_nodes"], 2 * sh["n_edges"], sh["d_feat"]
        assert a.fwd_flops(n, e, d) == ref_a.fwd_flops(n, e, d), name
    shapes = jax.eval_shape(lambda k: ref_a.init(k, 16, 7), jax.random.key(0))
    want = {k: tuple(v.shape) for k, v in G.gnn_params_from_numpy(
        arch, jax.tree.map(lambda x: np.zeros(x.shape, np.float32), shapes)).items()}
    got = {k: tuple(v.shape) for k, v in a.init(16, 7, device="cpu").state_dict().items()}
    assert got == want


def test_entry_points_raise_on_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for arch in ARCHS:
        with pytest.raises(RuntimeError, match="cuda"):
            GNN_ARCHS[arch].init(8, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        C.gnn_smoke(GNN_ARCHS["gin-tu"])


# --------------------------------------------------------------------------
# the sampler and the molecule stream
# --------------------------------------------------------------------------

def test_device_csr_equals_build_csr():
    """The sampler's CSR, built by a stable sort on the graph's device,
    array for array against the host `build_csr` and the reference's."""
    ref_g, g, *_ = _graph(n=150, deg=5.0, seed=7)
    indptr, indices = S.device_csr(g)
    want_ptr, want_idx = build_csr(g)
    ref_ptr, ref_idx = ref_build_csr(ref_g)
    assert indptr.dtype == torch.int64 and indices.dtype == torch.int32
    np.testing.assert_array_equal(indptr.numpy(), want_ptr)
    np.testing.assert_array_equal(indices.numpy(), want_idx)
    np.testing.assert_array_equal(indptr.numpy(), ref_ptr)
    np.testing.assert_array_equal(indices.numpy(), ref_idx)


def _ref_sampler_draws(key, batch, fanout):
    """NeighborSampler.sample's draws: per hop, split the key and draw."""
    out, shape = [], (batch,)
    for f in fanout:
        key, sub = jax.random.split(key)
        shape = shape + (f,)
        out.append(np.asarray(jax.random.randint(sub, shape, 0, jnp.iinfo(jnp.int32).max,
                                                  dtype=jnp.int32)))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_sampler_fed_the_reference_draws_matches(seed):
    """NeighborSampler on the reference's draws: the same layers and masks;
    tree_edges array for array; aggregate_mean within 1e-6.  Isolated
    vertices take the masked path."""
    ref_g = ref_erdos_renyi(200, avg_deg=1.0, seed=seed)
    g = erdos_renyi(200, avg_deg=1.0, seed=seed, device="cpu")
    seeds = np.arange(0, 40, 5, dtype=np.int32)
    fanout = (5, 3)
    key = jax.random.key(seed)
    want = ref_sampler.NeighborSampler(ref_g, fanout).sample(key, jnp.asarray(seeds))
    sampler = S.NeighborSampler(g, fanout)
    sub = sampler.sample_draws(torch.from_numpy(seeds), _t(*_ref_sampler_draws(key, 8, fanout)))
    assert sub.batch == want.batch == 8
    assert any(not bool(m.all()) for m in sub.masks[1:]), "no masked slot in the case"
    for got_l, want_l in zip(sub.layers + sub.masks, want.layers + want.masks):
        assert got_l.shape == want_l.shape
        np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    for got_a, want_a in zip(S.tree_edges(sub), ref_sampler.tree_edges(want)):
        np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    x = np.random.default_rng(seed).standard_normal((8, 5, 3, 4)).astype(np.float32)
    np.testing.assert_allclose(
        S.aggregate_mean(torch.from_numpy(x), sub.masks[2]).numpy(),
        np.asarray(ref_sampler.aggregate_mean(jnp.asarray(x), want.masks[2])),
        rtol=1e-6, atol=1e-7)


def test_draws_have_the_reference_shapes_and_range():
    u1, u2 = C.minibatch_draws(prng.key(0), 6, (4, 3), "cpu")
    assert u1.shape == (6, 4) and u2.shape == (6, 4, 3)
    sampler = S.NeighborSampler(erdos_renyi(20, avg_deg=2.0, seed=0, device="cpu"), (4, 3, 2))
    draws = sampler.draws(prng.key(0), 6)
    assert [tuple(u.shape) for u in draws] == [(6, 4), (6, 4, 3), (6, 4, 3, 2)]
    for u in (u1, u2) + draws:
        assert u.dtype == torch.int32 and int(u.min()) >= 0 and int(u.max()) < S.DRAW_HIGH


@pytest.mark.parametrize("step", [0, 3])
def test_graph_batch_stream_equals_the_reference(step):
    got = GraphBatchStream(batch=5, seed=2).batch_at(step)
    want = RefGraphBatchStream(batch=5, seed=2).batch_at(step)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
