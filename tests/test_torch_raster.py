"""The port's rasterizer (K2, K3, K4, K5 contracts): its plain versions
against the JAX functions on the CPU, the copied atlas tables, the camera
helpers, `IUVRenderer`, `PartRenderer`, the device dispatch, and (on a card
only) the CUDA kernel against the plain version.

Bars: pixels identical on >= 99.99% against JAX (XLA may contract a
product the port rounds twice, which moves a pixel centre lying on an edge
within an ulp), exactly equal on the closed test mesh; the kernel against
the plain version on the card is expected bit-identical."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from danet_densepose2smpl_tpu.kernels import rasterizer as jr
from danet_densepose2smpl_tpu.kernels.part_renderer import PartRenderer as JPartRenderer
from danet_densepose2smpl_tpu.kernels.rasterizer_pallas import (
    backface_mask as jax_backface_mask,
    rasterize_flat_pallas_banded,
    rasterize_flat_pallas_bandrange,
)
from danet_densepose2smpl_tpu.smpl import densepose_atlas as jatlas
from danet_densepose2smpl_tpu.smpl import smpl_forward_aa as jax_smpl_forward_aa
from danet_densepose2smpl_tpu.smpl.loader import synthetic_smpl_model as jax_synthetic_smpl

from danet_densepose2smpl_tpu_torch.kernels import rasterizer as R
from danet_densepose2smpl_tpu_torch.kernels.part_renderer import PartRenderer
from danet_densepose2smpl_tpu_torch.smpl import densepose_atlas as atlas_mod
from danet_densepose2smpl_tpu_torch.smpl.loader import synthetic_smpl_model

torch.set_num_threads(1)
AGREE = 0.9999


def _t(a):
    return torch.from_numpy(np.array(a))


def _agree(a, b):
    return np.isclose(np.asarray(a), np.asarray(b), atol=0, rtol=0).all(-1).mean()


def _closed_fixture(num_verts, seed, b, rng_seed=1):
    """tests/test_rasterizer.py::_closed_fixture, as numpy."""
    verts, faces = jatlas.closed_test_mesh(num_verts, seed=seed)
    faces, conflicts = jatlas.orient_faces(faces, verts)
    assert conflicts == 0
    rng = np.random.RandomState(rng_seed)
    vb = np.stack([verts * (1 + 0.1 * rng.randn()) + rng.randn(3) * 0.05 for _ in range(b)]).astype(np.float32)
    cam = np.tile([0.9, 0.02, -0.03], (b, 1)).astype(np.float32)
    tex = rng.rand(len(faces), 3).astype(np.float32)
    vpx = np.asarray(jr.project_weak_perspective(jnp.asarray(vb), jnp.asarray(cam), 224.0))
    return vb, cam, faces, tex, vpx


@pytest.fixture(scope="module")
def soup_scene():
    """The full-size synthetic atlas (13,776 faces) under posed synthetic
    SMPL bodies, B=2."""
    smpl = jax_synthetic_smpl()
    atlas = jatlas.synthetic_densepose_atlas(smpl)
    rng = np.random.RandomState(4)
    out = jax_smpl_forward_aa(smpl, jnp.asarray(rng.randn(2, 10) * 0.5, jnp.float32),
                              jnp.asarray(rng.randn(2, 72) * 0.3, jnp.float32))
    cam = np.array([[0.9, 0.02, -0.05], [0.8, -0.04, 0.03]], np.float32)
    vpx = np.asarray(jr.project_weak_perspective(out.vertices, jnp.asarray(cam)))
    return smpl, atlas, np.asarray(out.vertices), cam, vpx


# --------------------------------------------------------------------------
# copied tables and camera helpers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["closed_test_mesh", "orient_faces", "closed_synthetic_atlas",
                                  "synthetic_densepose_atlas"])
def test_atlas_tables_equal(name):
    if name == "closed_test_mesh":
        ours, theirs = atlas_mod.closed_test_mesh(700, seed=3), jatlas.closed_test_mesh(700, seed=3)
    elif name == "orient_faces":
        verts, faces = jatlas.closed_test_mesh(700, seed=3)
        ours, theirs = atlas_mod.orient_faces(faces, verts), jatlas.orient_faces(faces, verts)
    elif name == "closed_synthetic_atlas":
        (a, va), (b, vb) = atlas_mod.closed_synthetic_atlas(700, seed=2), jatlas.closed_synthetic_atlas(700, seed=2)
        ours, theirs = tuple(a) + (a.face_textures, va), tuple(b) + (b.face_textures, vb)
    else:
        a = atlas_mod.synthetic_densepose_atlas(synthetic_smpl_model(num_verts=400, seed=1), seed=1)
        b = jatlas.synthetic_densepose_atlas(jax_synthetic_smpl(num_verts=400, seed=1), seed=1)
        ours, theirs = tuple(a) + (a.face_textures,), tuple(b) + (b.face_textures,)
    assert len(ours) == len(theirs)
    for x, y in zip(ours, theirs):
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_camera_helpers(rng):
    verts = rng.randn(2, 40, 3).astype(np.float32) * 0.3
    cam = np.array([[0.9, 0.05, -0.02], [1.1, 0.0, 0.1]], np.float32)
    faces = rng.randint(0, 40, (60, 3)).astype(np.int32)
    np.testing.assert_allclose(R.camera_space(_t(verts), _t(cam)).numpy(),
                               np.asarray(jr.camera_space(jnp.asarray(verts), jnp.asarray(cam))), rtol=1e-6)
    vpx = R.project_weak_perspective(_t(verts), _t(cam))
    jvpx = jr.project_weak_perspective(jnp.asarray(verts), jnp.asarray(cam))
    np.testing.assert_allclose(vpx.numpy(), np.asarray(jvpx), rtol=1e-6, atol=1e-4)
    f64 = _t(faces).long()
    _, dead = R.dead_faces(_t(np.asarray(jvpx)), f64)
    _, jdead = jr.dead_faces(jvpx, jnp.asarray(faces))
    np.testing.assert_array_equal(dead.numpy(), np.asarray(jdead))
    np.testing.assert_array_equal(
        R.backface_mask(_t(verts), _t(cam), f64).numpy(),
        np.asarray(jax_backface_mask(jnp.asarray(verts), jnp.asarray(cam), jnp.asarray(faces))))


# --------------------------------------------------------------------------
# plain versions against the JAX functions
# --------------------------------------------------------------------------

def test_rasterize_flat_plain_full_synthetic_atlas(soup_scene):
    smpl, atlas, _, _, vpx = soup_scene
    faces, tex = atlas.faces, atlas.face_textures
    exp = np.asarray(jr.rasterize_flat(jnp.asarray(vpx), jnp.asarray(faces), jnp.asarray(tex), 56))
    got = R.rasterize_flat_plain(_t(vpx), _t(faces).long(), _t(tex), 56, chunk=1024)
    assert got.shape == (2, 56, 56, 3) and got.dtype == torch.float32
    assert (exp[..., 0] > 0).mean() > 0.02
    assert _agree(got, exp) >= AGREE
    # `chunk` is a memory knob only
    np.testing.assert_array_equal(R.rasterize_flat_plain(_t(vpx), _t(faces).long(), _t(tex), 56, chunk=700).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("nf", [40, 120, 300])
def test_rasterize_flat_plain_random_soups(nf):
    """The random soups of tests/test_rasterizer.py."""
    rng = np.random.RandomState(nf)
    b, nv = 2, 50
    verts = rng.randn(b, nv, 3).astype(np.float32) * 0.12
    cam = np.tile([0.9, 0.0, 0.0], (b, 1)).astype(np.float32)
    faces = rng.randint(0, nv, (nf, 3)).astype(np.int32)
    tex = rng.rand(nf, 3).astype(np.float32)
    vpx = np.asarray(jr.project_weak_perspective(jnp.asarray(verts), jnp.asarray(cam)))
    exp = np.asarray(jr.rasterize_flat(jnp.asarray(vpx), jnp.asarray(faces), jnp.asarray(tex), 56, chunk=64))
    got = R.rasterize_flat_plain(_t(vpx), _t(faces).long(), _t(tex), 56, chunk=64)
    assert _agree(got, exp) >= AGREE


def test_rasterize_flat_plain_exact_on_closed_test_mesh():
    _, _, faces, tex, vpx = _closed_fixture(900, seed=0, b=2)
    exp = np.asarray(jr.rasterize_flat(jnp.asarray(vpx), jnp.asarray(faces), jnp.asarray(tex), 56, 224.0, 256))
    got = R.rasterize_flat_plain(_t(vpx), _t(faces).long(), _t(tex), 56, 224.0, 256)
    assert (exp[..., 0] > 0).mean() > 0.02
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("num_verts,budget_frac,chunk", [
    (900, 0.6, 256),      # budget over every face: the fall-through to rasterize_flat
    (900, 1.0, 128),      # budget_frac >= 1: the same fall-through
    (900, 0.2, 256),      # budget 1024 of ~1,800 faces: live faces plus dead filler
    (2500, 0.2, 256),     # budget 1024 of ~5,000: live faces beyond it are dropped
])
def test_rasterize_flat_culled_plain_matches_jax(num_verts, budget_frac, chunk):
    _, _, faces, tex, vpx = _closed_fixture(num_verts, seed=0, b=2)
    exp = np.asarray(jr.rasterize_flat_culled(jnp.asarray(vpx), jnp.asarray(faces), jnp.asarray(tex),
                                              56, 224.0, chunk, budget_frac))
    got = R.rasterize_flat_culled_plain(_t(vpx), _t(faces).long(), _t(tex), 56, 224.0, chunk, budget_frac)
    np.testing.assert_array_equal(got.numpy(), exp)
    # the card's form of the same function: the full-order masked raster
    # with the face sets of `culled_face_sets`
    f64 = _t(faces).long()
    budget = R.cull_budget(len(faces), chunk, budget_frac)
    if budget < len(faces):
        skip, filler = R.culled_face_sets(_t(vpx), f64, budget)
        assert int((~skip).sum(1).max()) <= budget and not (skip & filler).any()
        masked = R.rasterize_flat_plain(_t(vpx), f64, _t(tex), 56, 224.0, chunk, skip, filler)
        np.testing.assert_array_equal(masked.numpy(), exp)


def _tie_scene():
    """4,000 faces, one image at S=16: face 0 is back-facing (dead), face 1
    the same triangle wound the other way (live), both at z = 4 with
    dyadic barycentrics, so their depths tie exactly; the other faces lie
    behind the camera. Fewer faces are live than the budget of 3,072, so
    face 0 fills the compacted prefix after face 1."""
    n = 4000
    verts = np.zeros((1, 3 + 3 * n, 3), np.float32)
    verts[0, :3] = [[0, 0, 4], [8, 0, 4], [0, 8, 4]]
    verts[0, 3:, 2] = -1.0
    faces = np.arange(3 + 3 * n).reshape(-1, 3)[:n + 1].copy()
    faces[0], faces[1] = [0, 1, 2], [0, 2, 1]
    faces = faces[:n]
    tex = np.random.RandomState(0).rand(n, 3).astype(np.float32) + 0.5
    return verts, faces, tex


def test_culled_exact_tie_goes_to_the_live_face():
    """K5 resolves an exact z-tie between a live face and a dead filler
    face by compacted order (live first), whatever their ids; the card's
    form of the culled entry holds the same order through `ties_last`."""
    verts, faces, tex = _tie_scene()
    f64 = _t(faces).long()
    _, dead = R.dead_faces(_t(verts), f64)
    assert bool(dead[0, 0]) and not bool(dead[0, 1])
    exp = np.asarray(jr.rasterize_flat_culled(jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(tex),
                                              16, 16.0, 1024, 0.55))
    got = R.rasterize_flat_culled(_t(verts), f64, _t(tex), 16, 16.0, 1024, 0.55)
    np.testing.assert_array_equal(got.numpy(), exp)
    covered = exp[0, ..., 0] > 0
    assert covered.mean() > 0.1
    np.testing.assert_array_equal(exp[0][covered], np.broadcast_to(tex[1], exp[0][covered].shape))
    skip, filler = R.culled_face_sets(_t(verts), f64, R.cull_budget(len(faces), 1024, 0.55))
    assert bool(filler[0, 0]) and not bool(skip[0, 0])
    masked = R.rasterize_flat_masked(_t(verts), f64, _t(tex), 16, 16.0, skip, 1024, filler)
    np.testing.assert_array_equal(masked.numpy(), exp)
    # without the tie order the full-order raster keeps the lower id
    by_id = R.rasterize_flat_masked(_t(verts), f64, _t(tex), 16, 16.0, skip, 1024)
    np.testing.assert_array_equal(by_id[0][covered].numpy(), np.broadcast_to(tex[0], exp[0][covered].shape))


def test_rasterize_flat_masked_plain_matches_jax_bandrange():
    """K4 with its backface cull mask (interpret mode) against the masked
    plain version."""
    vb, cam, faces, tex, vpx = _closed_fixture(900, seed=0, b=2, rng_seed=3)
    mask = jax_backface_mask(jnp.asarray(vb), jnp.asarray(cam), jnp.asarray(faces))
    exp = np.asarray(rasterize_flat_pallas_bandrange(
        jnp.asarray(vpx), jnp.asarray(faces), jnp.asarray(tex), 56, interpret=True, cull_mask=mask))
    ours_mask = R.backface_mask(_t(vb), _t(cam), _t(faces).long())
    np.testing.assert_array_equal(ours_mask.numpy(), np.asarray(mask))
    got = R.rasterize_flat_masked(_t(vpx), _t(faces).long(), _t(tex), 56, cull_mask=ours_mask)
    assert (exp[..., 0] > 0).mean() > 0.02
    assert _agree(got, exp) >= AGREE


@pytest.mark.parametrize("backend,cull", [("xla", False), ("xla", True), ("pallas", False),
                                          ("pallas_bandrange", True)])
def test_iuv_renderer_matches_jax(backend, cull):
    """IUVRenderer on the closed synthetic atlas, every backend name,
    against the JAX renderer's 'xla' form of the same function, and
    live_fraction equal."""
    atlas, verts = jatlas.closed_synthetic_atlas(700, seed=4)
    rng = np.random.RandomState(5)
    vb = np.stack([verts * (1 + 0.1 * rng.randn()) + rng.randn(3) * 0.05 for _ in range(3)]).astype(np.float32)
    cam = np.tile([0.85, 0.0, 0.05], (3, 1)).astype(np.float32)
    cull_verts = verts if cull else None
    jrend = jr.IUVRenderer(atlas, chunk=256, cull_verts=cull_verts)
    rend = R.IUVRenderer(atlas, chunk=256, cull_verts=cull_verts, backend=backend)
    assert rend.cull == jrend.cull == cull
    exp = np.asarray(jrend(jnp.asarray(vb), jnp.asarray(cam)))
    got = rend(_t(vb), _t(cam))
    assert got.shape == (3, 56, 56, 3) and (exp[..., 0] > 0).mean() > 0.02
    assert _agree(got, exp) >= AGREE
    if cull:
        np.testing.assert_allclose(rend.live_fraction(_t(vb), _t(cam)).numpy(),
                                   np.asarray(jrend.live_fraction(jnp.asarray(vb), jnp.asarray(cam))), atol=1e-7)


def test_renderer_soup_atlas_disables_culling():
    smpl = synthetic_smpl_model(num_verts=400)
    with pytest.warns(UserWarning, match="conflicted"):
        r = R.IUVRenderer(atlas_mod.synthetic_densepose_atlas(smpl), cull_verts=smpl.v_template)
    assert not r.cull
    with pytest.raises(ValueError, match="backend"):
        R.IUVRenderer(atlas_mod.synthetic_densepose_atlas(smpl), backend="banded")


# --------------------------------------------------------------------------
# the banded raster (K3) and PartRenderer
# --------------------------------------------------------------------------

def _soup(seed, b, nv, nf, spread, s, dtype=np.float32, n_invalid=0):
    """Random soup in the 224 px frame, for an S x S map; `spread` sets how
    many rows a face spans. The first `n_invalid` faces get a corner behind the
    camera or collapse to a line, so they can cover nothing."""
    rng = np.random.RandomState(seed)
    verts = rng.randn(b, nv, 3) * spread
    cam = np.tile([0.9, 0.0, 0.0], (b, 1))
    faces = rng.randint(0, nv, (nf, 3))
    vpx = np.asarray(jr.project_weak_perspective(jnp.asarray(verts, jnp.float32),
                                                 jnp.asarray(cam, jnp.float32))).astype(dtype)
    vpx = np.concatenate([vpx, vpx[:, :2] * [1, 1, -1], vpx[:, :1] * [1, 1, 1]], axis=1)
    bad = np.stack([np.array([nv, nv + 1, 0]), np.array([nv + 2, nv + 2, 1])])[np.arange(n_invalid) % 2]
    faces = np.concatenate([bad, faces])
    return vpx, faces, rng.rand(len(faces), 3).astype(dtype)


@pytest.mark.parametrize("s,chunk,spread,n_invalid,dtype", [
    (56, 64, 0.12, 0, np.float32),
    (40, 16, 0.6, 9, np.float32),      # faces spanning many bands, invalid faces
    (23, 32, 0.5, 5, np.float64),      # S not a multiple of 16, f64
    (50, 1024, 0.2, 3, np.float32),    # one ragged chunk
])
def test_rasterize_flat_banded_plain_equals_rasterize_flat_plain(s, chunk, spread, n_invalid, dtype):
    vpx, faces, tex = _soup(s, 2, 60, 400, spread, s, dtype, n_invalid)
    args = (_t(vpx), _t(faces).long(), _t(tex), s, 224.0)
    exp = R.rasterize_flat_plain(*args, chunk=128)
    got = R.rasterize_flat_banded_plain(*args, chunk=chunk)
    assert got.dtype == exp.dtype and (exp[..., 0] > 0).double().mean() > 0.02
    np.testing.assert_array_equal(got.numpy(), exp.numpy())
    # the wrapper on a CPU tensor is the plain version and launches nothing
    before = R.rasterize_flat_banded.launches
    np.testing.assert_array_equal(R.rasterize_flat_banded(*args, chunk).numpy(), exp.numpy())
    assert R.rasterize_flat_banded.launches == before


def test_band_setup_and_face_boxes():
    """The stable y-centre order, and the boxes the kernel's extents are
    built from: empty for faces that can cover nothing."""
    vpx, faces, _ = _soup(3, 2, 30, 50, 0.2, 56, n_invalid=4)
    v, f = _t(vpx), _t(faces).long()
    order = R.band_setup(v, f, 56, 56.0)
    yc = (v[:, f, 1]).mean(-1)
    assert bool((yc.gather(1, order).diff(dim=1) >= 0).all())
    tie = torch.zeros(1, 6, 3)                                  # every face on one row: the identity
    np.testing.assert_array_equal(R.band_setup(tie, torch.arange(6).reshape(2, 3).repeat(2, 1), 8, 8.0)[0],
                                  np.arange(4))
    tri = v[:, f]
    box = R.face_boxes(tri[..., :2], tri[..., 2])
    assert box.dtype == torch.float32
    np.testing.assert_array_equal(box[:, :4].numpy(), np.broadcast_to(np.float32([1e30, -1e30, 1e30, -1e30]), (2, 4, 4)))
    shown = box[..., 0] < 1e30
    assert shown[:, 4:].float().mean() > 0.9
    np.testing.assert_allclose(box[shown][:, 0], tri[shown][:, :, 0].min(-1).values - 1, rtol=1e-6)
    np.testing.assert_allclose(box[shown][:, 3], tri[shown][:, :, 1].max(-1).values + 1, rtol=1e-6)


def test_rasterize_flat_banded_exact_against_jax_rasterize_flat():
    """0 pixels of difference from the JAX `rasterize_flat` on the closed
    test mesh at 224 x 224 and at S=100."""
    _, _, faces, tex, vpx = _closed_fixture(900, seed=0, b=2)
    for s in (224, 100):
        exp = np.asarray(jr.rasterize_flat(jnp.asarray(vpx), jnp.asarray(faces), jnp.asarray(tex), s, 224.0, 512))
        got = R.rasterize_flat_banded(_t(vpx), _t(faces).long(), _t(tex), s, 224.0, 256)
        assert (exp[..., 0] > 0).mean() > 0.02
        np.testing.assert_array_equal(got.numpy(), exp)


def test_rasterize_flat_banded_agrees_with_jax_k3_interpret():
    """Above 99.9% of pixels against K3 itself in interpret mode, the JAX
    package's own bar (tests/test_rasterizer.py:139-140): K3 evaluates
    affine edge coefficients and keeps the first face in sorted order on a
    tie, where the port keeps K5's formulas and the least face id."""
    vb, cam, faces, tex, vpx = _closed_fixture(900, seed=0, b=2, rng_seed=2)
    exp = np.asarray(rasterize_flat_pallas_banded(jnp.asarray(vpx), jnp.asarray(faces), jnp.asarray(tex), 56,
                                                  interpret=True))
    got = R.rasterize_flat_banded(_t(vpx), _t(faces).long(), _t(tex), 56)
    assert (exp[..., 0] > 0).mean() > 0.02
    assert np.isclose(got.numpy(), exp, atol=1e-5).all(-1).mean() > 0.999


@pytest.mark.parametrize("backend", ["auto", "xla", "pallas_banded"])
def test_part_renderer_matches_jax(backend):
    """PartRenderer on a 300-vertex synthetic body at 64 px against the JAX
    renderer's XLA form (its 'pallas_banded' runs only as a TPU kernel), and
    mask / parts of the contract."""
    jsmpl = jax_synthetic_smpl(num_verts=300, seed=0)
    smpl = synthetic_smpl_model(num_verts=300, seed=0)
    rng = np.random.RandomState(6)
    betas, pose = rng.randn(2, 10) * 0.3, rng.randn(2, 72) * 0.2
    verts = np.asarray(jax_smpl_forward_aa(jsmpl, jnp.asarray(betas, jnp.float32),
                                           jnp.asarray(pose, jnp.float32)).vertices)
    cam = np.array([[0.9, 0.0, 0.0], [0.8, 0.05, -0.05]], np.float32)
    jmask, jparts = (np.asarray(a) for a in JPartRenderer(jsmpl, img_size=64, chunk=256)(
        jnp.asarray(verts), jnp.asarray(cam)))
    mask, parts = PartRenderer(smpl, img_size=64, chunk=256, backend=backend)(_t(verts), _t(cam))
    assert mask.dtype == torch.bool and parts.dtype == torch.int32 and mask.shape == (2, 64, 64)
    assert 0.01 < jmask.mean() < 0.9
    np.testing.assert_array_equal(mask.numpy(), jmask)
    np.testing.assert_array_equal(parts.numpy(), jparts)
    np.testing.assert_array_equal(parts.numpy() > 0, mask.numpy())
    with pytest.raises(ValueError, match="backend"):
        PartRenderer(smpl, backend="banded")


# --------------------------------------------------------------------------
# the pair kernel's algorithm (csrc/rasterizer.cu, fp32), emulated on the CPU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("regime", ["working range", "positive subnormals and normals"])
def test_depth_key_orders_like_z_then_rank(regime):
    """The least `depth_key` is the least (z, rank): z in the kernel's range
    (1e-6, 1e9) with equal values, adjacent ulps and both ends' neighbours;
    and, since positive floats order as their bits, down through the
    subnormals. Ranks span [0, 2F) of the 13,776-face mesh."""
    rng = np.random.RandomState(7 if regime == "working range" else 8)
    n = 4000
    if regime == "working range":
        z = np.exp(rng.uniform(np.log(1e-6), np.log(1e9), n)).astype(np.float32)
        edges = np.float32([np.nextafter(np.float32(1e-6), np.float32(1)), np.nextafter(np.float32(1e9), np.float32(0)),
                            1.0, np.nextafter(np.float32(1), np.float32(2)),
                            np.nextafter(np.float32(1), np.float32(0))])
    else:
        z = rng.randint(1, 2 ** 24, n).astype(np.int32).view(np.float32)        # subnormals and tiny normals
        edges = np.array([1, 2, 2 ** 23 - 1, 2 ** 23, 2 ** 23 + 1], np.int32).view(np.float32)
    z[: len(edges)] = edges
    z[len(edges): 2 * len(edges)] = edges                                        # exact ties in z
    z[2 * len(edges):] = np.where(rng.rand(n - 2 * len(edges)) < 0.2,           # ulp neighbours
                                  np.nextafter(z[2 * len(edges):], np.float32(np.inf)), z[2 * len(edges):])
    rank = rng.randint(0, 2 * 13776, n)
    rank[:2] = [0, 2 * 13776 - 1]
    key = R.depth_key(torch.from_numpy(z), torch.from_numpy(rank)).numpy()
    assert key.dtype == np.int64 and (key >= 0).all() and (key < R._EMPTY_KEY).all()
    i, j = rng.randint(0, n, (2, 200000))
    i[:n], j[:n] = np.arange(n), np.roll(np.arange(n), 1)
    lex = (z[i] < z[j]) | ((z[i] == z[j]) & (rank[i] < rank[j]))
    np.testing.assert_array_equal(key[i] < key[j], lex)
    np.testing.assert_array_equal(key[i] == key[j], (z[i] == z[j]) & (rank[i] == rank[j]))


def _span_scene(name):
    """(verts_px (B, V, 3) fp32 in the 224 px frame, faces (F, 3), S) of
    one kind of face."""
    rng = np.random.RandomState(11)
    if name == "random soup":
        vpx, faces, _ = _soup(12, 2, 60, 400, 0.4, 48, n_invalid=9)
        return vpx.astype(np.float32), faces, 48
    if name == "closed test mesh":
        _, _, faces, _, vpx = _closed_fixture(900, seed=0, b=2)
        return vpx.astype(np.float32), faces, 56
    n = 300
    a = rng.uniform(-40 if name == "off-image" else 20, 264 if name == "off-image" else 204, (2, n, 2))
    d = rng.randn(2, n, 2) * (60 if name == "off-image" else 30)
    if name == "thin and near-degenerate":
        perp = np.stack([-d[..., 1], d[..., 0]], -1) / np.linalg.norm(d, axis=-1, keepdims=True)
        width = 10.0 ** rng.uniform(-7, 0.5, (2, n, 1))                            # 1e-7 to 3 px across
        c = a + d * rng.rand(2, n, 1) + perp * width
    else:                                                                          # off-image: far and huge faces too
        c = a + rng.randn(2, n, 2) * 300
    xy = np.stack([a, a + d, c], 2)                                                 # (2, n, 3, 2)
    z = rng.uniform(0.5, 3.0, (2, n, 3))
    z[:, :5, 0] = -1.0                                                               # behind the camera: invalid
    vpx = np.concatenate([xy, z[..., None]], -1).reshape(2, 3 * n, 3).astype(np.float32)
    return vpx, np.arange(3 * n).reshape(n, 3), 56


@pytest.mark.parametrize("name", ["random soup", "thin and near-degenerate", "off-image", "closed test mesh"])
def test_pixel_spans_cover_every_inside_pair(name):
    """Every (pixel, face) pair that K5's formulas (`_chunk_depths`) find
    inside lies in the face's `pixel_spans` span, so the pair kernel misses
    none; faces that can cover no pixel, and skipped faces, have none."""
    vpx, faces, s = _span_scene(name)
    tri = _t(vpx)[:, _t(faces).long()]
    xy, z = tri[..., :2] * (s / 224.0), tri[..., 2]
    span, count = R.pixel_spans(xy, z, s)
    centres = R._pixel_centers(s, torch.float32, "cpu")
    rows, cols = torch.arange(s * s) // s, torch.arange(s * s) % s
    n_inside = 0
    for f0 in range(0, faces.shape[0], 256):
        sl = slice(f0, f0 + 256)
        inside = R._chunk_depths(xy[:, sl], z[:, sl], centres[..., 0], centres[..., 1]) < R._BIG   # (B, P, K)
        bi, pi, ki = torch.nonzero(inside, as_tuple=True)
        sp = span[:, sl][bi, ki]
        assert bool(((cols[pi] >= sp[:, 0]) & (cols[pi] < sp[:, 0] + sp[:, 2])
                     & (rows[pi] >= sp[:, 1]) & (rows[pi] < sp[:, 1] + sp[:, 3])).all())
        n_inside += len(pi)
    assert n_inside > 50 and int(count.sum()) >= n_inside
    x, y = xy[..., 0], xy[..., 1]
    area = (x[..., 1] - x[..., 0]) * (y[..., 2] - y[..., 0]) - (y[..., 1] - y[..., 0]) * (x[..., 2] - x[..., 0])
    invalid = (area.abs() <= 1e-12) | (z <= 0).any(-1)
    assert int(count[invalid].sum()) == 0 and (invalid.any() or name == "closed test mesh")
    skip = torch.from_numpy(np.random.RandomState(1).rand(*count.shape) < 0.5)
    _, skipped = R.pixel_spans(xy, z, s, skip)
    assert int(skipped[skip].sum()) == 0 and torch.equal(skipped[~skip], count[~skip])


def _emulate_pair_kernel(vpx, faces, tex, s, orig=224.0, skip=None, ties_last=None):
    """The pair kernel's algorithm on the CPU: the pairs of face f of image
    b are its `pixel_spans`, pair q being pixel (x0 + q mod w, y0 + q div
    w); each pair's depth comes from K5's formulas, and the z-buffer keeps
    the least `depth_key` of (z, rank) by scatter_reduce('amin'); rank is
    the face id, plus F for `ties_last` faces; the resolve pass decodes
    it."""
    b, n_faces = vpx.shape[0], faces.shape[0]
    tri = vpx[:, faces]
    xy, z = tri[..., :2] * (s / orig), tri[..., 2]
    span, count = R.pixel_spans(xy, z, s, skip)
    rank = torch.arange(n_faces).expand(b, n_faces) + (n_faces * ties_last.long() if ties_last is not None else 0)
    count = count.reshape(-1)
    slot = torch.repeat_interleave(torch.arange(b * n_faces), count)
    q = torch.arange(len(slot)) - (torch.cumsum(count, 0) - count)[slot]
    sp = span.reshape(-1, 4)[slot]
    col, row = sp[:, 0] + q % sp[:, 2], sp[:, 1] + q // sp[:, 2]
    px = (col.to(vpx.dtype) + 0.5).reshape(1, 1, -1)
    py = (row.to(vpx.dtype) + 0.5).reshape(1, 1, -1)
    depth = R._chunk_depths(xy.reshape(1, -1, 3, 2)[:, slot], z.reshape(1, -1, 3)[:, slot], px, py)[0, 0]
    ok = depth < R._BIG
    pix = ((slot // n_faces) * s + row) * s + col
    zbuf = torch.full((b * s * s,), R._EMPTY_KEY, dtype=torch.int64).scatter_reduce(
        0, pix[ok], R.depth_key(depth[ok], rank.reshape(-1)[slot][ok]), "amin")
    won = zbuf & 0xFFFFFFFF
    won = torch.where(zbuf == R._EMPTY_KEY, n_faces, torch.where(won >= n_faces, won - n_faces, won))
    table = torch.cat([tex, tex.new_zeros(1, tex.shape[1])], dim=0)
    return table[won].reshape(b, s, s, -1), int(count.sum())


@pytest.mark.parametrize("case", ["random soup", "closed test mesh", "backface mask", "culled face sets",
                                  "exact tie", "banded entry"])
def test_pair_kernel_algorithm_equals_plain(case):
    """The emulated pair kernel equals `rasterize_flat_plain` bit for bit:
    plain, with a skip mask, with `culled_face_sets` (skip and ties_last),
    on the exact-tie scene of `test_culled_exact_tie_goes_to_the_live_face`;
    and `rasterize_flat_banded_plain` (K3's y-order and chunk skipping),
    whose entry runs the same kernel on the card."""
    kw, orig = {}, 224.0
    if case == "random soup":
        vpx, faces, tex = (_t(a) for a in _soup(13, 2, 60, 400, 0.5, 48, n_invalid=7))
        s = 48
    elif case == "exact tie":
        vpx, faces, tex = (_t(a) for a in _tie_scene())
        s, orig = 16, 16.0
    else:
        vb, cam, faces, tex, vpx = _closed_fixture(900, seed=0, b=2, rng_seed=3)
        vpx, faces, tex, s = _t(vpx), _t(faces), _t(tex), 56
        if case == "backface mask":
            kw["skip"] = R.backface_mask(_t(vb), _t(cam), faces.long())
    faces = faces.long()
    if case in ("culled face sets", "exact tie"):
        budget = R.cull_budget(len(faces), 256 if case == "culled face sets" else 1024,
                               0.2 if case == "culled face sets" else 0.55)
        kw["skip"], kw["ties_last"] = R.culled_face_sets(vpx, faces, budget)
        assert bool(kw["ties_last"].any())
    if case == "banded entry":
        exp = R.rasterize_flat_banded_plain(vpx, faces, tex, s, orig, 256)
    else:
        exp = R.rasterize_flat_plain(vpx, faces, tex, s, orig, 256, kw.get("skip"), kw.get("ties_last"))
    got, n_pairs = _emulate_pair_kernel(vpx, faces, tex, s, orig, **kw)
    assert (exp[..., 0] > 0).double().mean() > 0.02 and n_pairs > 0
    np.testing.assert_array_equal(got.numpy(), exp.numpy())
    if case == "exact tie":   # the live face wins the tie, as in K5's compacted order
        covered = exp[0, ..., 0] > 0
        np.testing.assert_array_equal(got[0][covered].numpy(), np.broadcast_to(tex[1].numpy(), got[0][covered].shape))


# --------------------------------------------------------------------------
# dispatch and the card
# --------------------------------------------------------------------------

def test_wrappers_on_cpu_never_launch():
    _, _, faces, tex, vpx = _closed_fixture(300, seed=1, b=2)
    before = (R.rasterize_flat.launches, R.rasterize_flat_masked.launches)
    args = (_t(vpx), _t(faces).long(), _t(tex), 32)
    np.testing.assert_array_equal(R.rasterize_flat(*args).numpy(), R.rasterize_flat_plain(*args).numpy())
    R.rasterize_flat_masked(*args, cull_mask=torch.zeros(2, len(faces), dtype=torch.bool))
    R.rasterize_flat_culled(*args, 224.0, 256, 0.3)
    assert (R.rasterize_flat.launches, R.rasterize_flat_masked.launches) == before
    with pytest.raises(ValueError, match="no kernel"):
        R.rasterize_flat(_t(vpx).to("meta"), _t(faces).long(), _t(tex), 32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernel_matches_plain(cuda_device, dtype):
    """Each entry on the card against its plain version. fp32 launches the
    kernel; fp64 has none: each entry runs its plain version there, bit for
    bit, and moves no launch counter."""
    vb, cam, faces, tex, vpx = _closed_fixture(2500, seed=0, b=3)
    v = _t(vpx).to(cuda_device, dtype)
    f, tx = _t(faces).long().to(cuda_device), _t(tex).to(cuda_device)
    mask = R.backface_mask(_t(vb).to(cuda_device, dtype), _t(cam).to(cuda_device, dtype), f)
    entries = (R.rasterize_flat, R.rasterize_flat_masked)
    before = sum(e.launches for e in entries)
    cases = [
        (R.rasterize_flat(v, f, tx, 56), R.rasterize_flat_plain(v, f, tx, 56)),
        (R.rasterize_flat_masked(v, f, tx, 56, cull_mask=mask),
         R.rasterize_flat_plain(v, f, tx, 56, skip=mask)),
        (R.rasterize_flat_culled(v, f, tx, 56, 224.0, 256, 0.2),
         R.rasterize_flat_culled_plain(v, f, tx, 56, 224.0, 256, 0.2)),
    ]
    torch.cuda.synchronize()
    fp64 = dtype == torch.float64
    assert sum(e.launches for e in entries) == before + (0 if fp64 else 3)
    for got, exp in cases:
        assert torch.equal(got, exp) if fp64 else _agree(got.cpu(), exp.cpu()) >= 1 - 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["closed test mesh", "backface mask", "culled face sets", "random soup, S=40"])
def test_cuda_pair_kernel_equals_plain(cuda_device, case):
    """The fp32 pair kernel against the plain version, bit for bit, and the
    pairs it enumerates against `pixel_spans`."""
    vb, cam, faces, tex, vpx = _closed_fixture(2500, seed=0, b=3)
    v, f, t, s, kw = _t(vpx), _t(faces).long(), _t(tex), 56, {}
    if case == "backface mask":
        kw["skip"] = R.backface_mask(_t(vb), _t(cam), f)
    elif case == "culled face sets":
        kw["skip"], kw["ties_last"] = R.culled_face_sets(v, f, R.cull_budget(len(faces), 256, 0.2))
    elif case == "random soup, S=40":
        v, f, t = (_t(a) for a in _soup(40, 2, 60, 700, 0.3, 40, n_invalid=9))
        v, f, s = v.float(), f.long(), 40
    v, f, t = v.to(cuda_device), f.to(cuda_device), t.to(cuda_device)
    kw = {k: m.to(cuda_device) for k, m in kw.items()}
    got, pairs = R._launch(v, f, t, s, 224.0, with_pairs=True, **kw)
    torch.cuda.synchronize()
    plain = R.rasterize_flat_plain(v, f, t, s, 224.0, 256, kw.get("skip"), kw.get("ties_last"))
    np.testing.assert_array_equal(got.cpu().numpy(), plain.cpu().numpy())
    tri = v[:, f]
    _, count = R.pixel_spans(tri[..., :2] * (s / 224.0), tri[..., 2], s, kw.get("skip"))
    assert int(pairs.item()) == int(count.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_banded_kernel_matches_plain(cuda_device, dtype):
    """K3's kernel against its plain version and the rasterize_flat kernel:
    bit-equal, at S=224 and at S=40 (not a multiple of 16) with invalid
    faces. fp64 runs both entries' plain versions and launches nothing."""
    _, _, faces, tex, vpx = _closed_fixture(2500, seed=0, b=3)
    cases = [(_t(vpx), _t(faces).long(), _t(tex), 224, 224.0)]
    v, f, t = _soup(40, 2, 60, 700, 0.3, 40, n_invalid=9)
    cases.append((_t(v), _t(f).long(), _t(t), 40, 224.0))
    launched = 0 if dtype == torch.float64 else 1
    for v, f, t, s, orig in cases:
        v, f, t = v.to(cuda_device, dtype), f.to(cuda_device), t.to(cuda_device)
        before = (R.rasterize_flat_banded.launches, R.rasterize_flat.launches)
        got = R.rasterize_flat_banded(v, f, t, s, orig)
        flat = R.rasterize_flat(v, f, t, s, orig)
        torch.cuda.synchronize()
        assert (R.rasterize_flat_banded.launches, R.rasterize_flat.launches) == tuple(n + launched for n in before)
        plain = R.rasterize_flat_banded_plain(v, f, t, s, orig, 256)
        np.testing.assert_array_equal(got.cpu().numpy(), plain.cpu().numpy())
        np.testing.assert_array_equal(got.cpu().numpy(), flat.cpu().numpy())


@pytest.mark.cuda
def test_cuda_kernel_culled_tie_order(cuda_device):
    verts, faces, tex = _tie_scene()
    args = (_t(verts).to(cuda_device), _t(faces).long().to(cuda_device), _t(tex).to(cuda_device), 16, 16.0, 1024, 0.55)
    got = R.rasterize_flat_culled(*args)
    np.testing.assert_array_equal(got.cpu().numpy(), R.rasterize_flat_culled_plain(*args).cpu().numpy())
