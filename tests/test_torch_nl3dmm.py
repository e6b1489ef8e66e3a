"""The port's NL-3DMM (``nl3dmm/face_model.py``, ``rasterizer.py``,
``loss.py``, ``fitting.py``) against the JAX package's on
``random_basis(256, 400)`` with the same decoder weights (JAX's draw,
carried across by ``utils/transplant.geometry_decoder_params_from_jax``):

* the face model, the losses and the soft rasterizer within 1e-5 (relative
  L2 for images, the readings ~1e-9), their gradients with respect to the
  vertices and colours within 1e-4 relative L2 (~4e-7);
* the binning's triangle ids equal JAX's, on a view of the sphere where many
  triangles cover whole tiles and tie;
* the fit at 2 + 2 steps: losses within 1e-5 relative, codes and cameras
  within 1e-4 relative L2 (readings ~3e-6 and ~1e-6); JAX's own 20 + 30
  step case: both loss curves fall and agree within 1e-3 (~2e-5);
* the loaders round-trip files the tests write."""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gazenerf_tpu.nl3dmm import face_model as JF  # noqa: E402
from gazenerf_tpu.nl3dmm import fitting as JFit  # noqa: E402
from gazenerf_tpu.nl3dmm import loss as JLoss  # noqa: E402
from gazenerf_tpu.nl3dmm import rasterizer as JR  # noqa: E402
from gazenerf_tpu_torch.nl3dmm import face_model as F  # noqa: E402
from gazenerf_tpu_torch.nl3dmm import fitting as Fit  # noqa: E402
from gazenerf_tpu_torch.nl3dmm import loss as Loss  # noqa: E402
from gazenerf_tpu_torch.nl3dmm import rasterizer as R  # noqa: E402
from gazenerf_tpu_torch.utils.transplant import geometry_decoder_params_from_jax  # noqa: E402
from torch_threads import one_thread  # noqa: F401,E402

OUT_TOL = 1e-5  # outputs: relative L2 (images) or max abs
GRAD_REL_L2 = 1e-4
FIT_LOSS_RTOL, FIT_REL_L2 = 1e-5, 1e-4  # 2 + 2 steps
CURVE_RTOL = 1e-3  # 20 + 30 steps


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def bases():
    return JF.random_basis(n_vertices=256, n_tris=400), F.random_basis(n_vertices=256, n_tris=400)


def _camera(B, focal=100.0, dist=4.0, size=128):
    Rm = np.tile(np.diag([1.0, -1.0, -1.0]).astype(np.float32), (B, 1, 1))
    T = np.tile(np.array([0.0, 0.0, dist], np.float32), (B, 1))
    K = np.tile(np.array([[focal, 0, size / 2], [0, focal, size / 2], [0, 0, 1]], np.float32),
                (B, 1, 1))
    return Rm, T, K


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(np.asarray(a))) for a in arrays]


def test_random_basis_and_face_model_match_jax(bases):
    """The seeded basis to the bit; the decoder (JAX's weights, and its mean
    shape in ``geo_fc3``'s bias), the texture model, both vertex-normal
    paths, the SH shading and the ambient code."""
    jb, b = bases
    for name, x, y in zip(F.BasisData._fields, jb, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy(), err_msg=name)
    jdec = JF.GeometryDecoder(jb)
    dec = F.GeometryDecoder(b)
    dec.load_state_dict(geometry_decoder_params_from_jax(jdec.init_params))
    rng = np.random.default_rng(0)
    code = rng.normal(0, 1, (2, 179)).astype(np.float32)
    jverts = jdec(jdec.init_params, jnp.asarray(code))
    with torch.no_grad():
        verts = dec(*_t(code))
    assert rel(verts, jverts) <= OUT_TOL
    # the seeded draw keeps upstream's structure: the mean shape in the bias
    np.testing.assert_array_equal(dec.geo_fc3.bias.detach().numpy(), b.mean_shape.reshape(-1))
    np.testing.assert_array_equal(dec.geo_fc3.weight.detach()[:, :179].numpy(), b.shape_basis)
    tex = rng.normal(0, 1, (2, 100)).astype(np.float32)
    albedo, jalbedo = F.decode_texture(b, *_t(tex)), JF.decode_texture(jb, jnp.asarray(tex))
    assert rel(albedo, jalbedo) <= OUT_TOL
    corr = rng.integers(0, 401, (256, 8)).astype(np.int32)  # sentinel 400 = the padding face
    for c in (None, corr):
        n = F.vertex_normals(*_t(jverts), b.triangles, None if c is None else torch.from_numpy(c))
        jn = JF.vertex_normals(jverts, jb.triangles, None if c is None else jnp.asarray(c))
        np.testing.assert_allclose(n.numpy(), np.asarray(jn), rtol=0, atol=OUT_TOL)
    illu = np.asarray(JF.init_illu_code(2)) + rng.normal(0, 0.1, (2, 27)).astype(np.float32)
    np.testing.assert_array_equal(F.init_illu_code(2).numpy(), np.asarray(JF.init_illu_code(2)))
    shaded = F.sh_shade(albedo, n, *_t(illu))
    assert rel(shaded, JF.sh_shade(jalbedo, jn, jnp.asarray(illu))) <= OUT_TOL


def test_max_splits_tied_gradients_as_jax():
    """The depth softmax's ``zmax`` is ``torch.amax``: like ``jnp.max`` it
    splits the gradient among ties (``Tensor.max(dim)`` does not)."""
    x = torch.tensor([2.0, 2.0, 1.0], requires_grad=True)
    torch.amax(x, dim=-1).backward()
    jg = jax.grad(lambda v: jnp.max(v, axis=-1))(jnp.asarray([2.0, 2.0, 1.0]))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jg))


def test_binning_ids_equal_jax_where_triangles_tie(bases):
    """The per-tile triangle ids on identical screen positions equal JAX's,
    close to the sphere (focal 600 at distance 4, 4-px tiles, K = 4: in 56
    tiles more than K triangles' boxes cover the tile whole, so their areas
    tie and the stable order decides which K a tile keeps) and from afar
    (16-px tiles, K = 64)."""
    jb, b = bases
    verts = np.asarray(jb.mean_shape)[None]
    for focal, ts, K_ in ((600.0, 4, 4), (100.0, 16, 64)):
        Rm, T, K = _camera(1, focal=focal)
        screen = np.asarray(JR.project_vertices(jnp.asarray(verts), *map(jnp.asarray, (Rm, T, K))))
        s = JR.RasterSettings(image_size=128, tile_size=ts, tris_per_tile=K_)
        ids = R._bin_triangles(*_t(screen[:1]), b.triangles, R.RasterSettings(*s))[0].numpy()
        jids = np.asarray(JR._bin_triangles(jnp.asarray(screen[0]), jb.triangles, s))
        np.testing.assert_array_equal(ids, jids)
        if focal == 600.0:  # tiles whose full-coverage ties outnumber K
            xy = screen[0][np.asarray(jb.triangles)][..., :2]
            lo, hi = xy.min(1), xy.max(1)  # [T, 2]
            t0 = np.arange(128 // ts) * ts
            cover_x = (lo[:, None, 0] <= t0) & (hi[:, None, 0] >= t0 + ts)
            cover_y = (lo[:, None, 1] <= t0) & (hi[:, None, 1] >= t0 + ts)
            full = (cover_y[:, :, None] & cover_x[:, None, :]).sum(0)
            assert (full > K_).sum() > 10, full.max()
    # batched binning equals the per-mesh one
    Rm, T, K = _camera(2)
    v2 = np.stack([verts[0], verts[0] * 0.9])
    sc = R.project_vertices(*_t(v2, Rm, T, K))
    s = R.RasterSettings(image_size=64, tile_size=16, tris_per_tile=32)
    both = R._bin_triangles(sc, b.triangles, s)
    for i in range(2):
        one = R._bin_triangles(sc[i : i + 1], b.triangles, s)[0]
        np.testing.assert_array_equal(both[i].numpy(), one.numpy())


@pytest.mark.parametrize("size,K_", [(64, 32), (128, 64)])
def test_soft_rasterizer_and_gradients_match_jax(bases, size, K_):
    """``render_mesh`` on perturbed spheres (B=2): images and alpha within
    OUT_TOL relative L2, the gradients of a weighted sum of both with
    respect to the vertices and the colours within GRAD_REL_L2; one mesh
    through ``rasterize_soft`` equals its batch row."""
    jb, b = bases
    rng = np.random.default_rng(size)
    Rm, T, K = _camera(2, focal=100.0 * size / 128, size=size)
    verts = (np.asarray(jb.mean_shape)[None] + rng.normal(0, 0.05, (2, 256, 3))).astype(np.float32)
    cols = rng.uniform(0, 1, (2, 256, 3)).astype(np.float32)
    W = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    Wa = rng.standard_normal((2, size, size)).astype(np.float32)
    s = JR.RasterSettings(image_size=size, tile_size=16, tris_per_tile=K_)

    def jloss(v, c):
        img, a = JR.render_mesh(v, c, jb.triangles, *map(jnp.asarray, (Rm, T, K)), s)
        return jnp.sum(img * W) + jnp.sum(a * Wa), (img, a)

    (_, (jimg, ja)), (jgv, jgc) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(verts), jnp.asarray(cols))
    v, c = (t.requires_grad_() for t in _t(verts, cols))
    img, a = R.render_mesh(v, c, b.triangles, *_t(Rm, T, K), R.RasterSettings(*s))
    ((img * torch.from_numpy(W)).sum() + (a * torch.from_numpy(Wa)).sum()).backward()
    assert rel(img.detach(), jimg) <= OUT_TOL and rel(a.detach(), ja) <= OUT_TOL
    assert rel(v.grad, jgv) <= GRAD_REL_L2 and rel(c.grad, jgc) <= GRAD_REL_L2
    assert float(a.detach()[0].max()) > 0.9 and float(a.detach()[0, 0, 0]) < 0.1  # a disc
    with torch.no_grad():
        sc = R.project_vertices(*_t(verts, Rm, T, K))
        one, one_a = R.rasterize_soft(sc[1:], c.detach()[1:], b.triangles, R.RasterSettings(*s))
    np.testing.assert_array_equal(one[0].numpy(), img.detach()[1].numpy())
    np.testing.assert_array_equal(one_a[0].numpy(), a.detach()[1].numpy())
    lm = R.project_landmarks(*_t(verts), b.landmark_index, *_t(Rm, T, K))
    jlm = JR.project_landmarks(jnp.asarray(verts), jb.landmark_index, *map(jnp.asarray, (Rm, T, K)))
    np.testing.assert_allclose(lm.numpy(), np.asarray(jlm), rtol=1e-6, atol=1e-4)


def test_loss_terms_match_jax(bases):
    jb, b = bases
    rng = np.random.default_rng(1)
    B = 2
    args = dict(
        batch_vcs=rng.uniform(0, 255, (B, 256, 3)), cur_illus=rng.normal(0, 1, (B, 27)),
        rendered_imgs=rng.random((B, 32, 32, 3)), gt_imgs=rng.random((B, 32, 32, 3)),
        mask_c3d=rng.random((B, 32, 32, 1)) > 0.4, proj_lm2ds=rng.uniform(0, 32, (B, 68, 2)),
        gt_lm2ds=rng.uniform(0, 32, (B, 68, 2)), iden_codes=rng.normal(0, 1, (B, 100)),
        text_codes=rng.normal(0, 1, (B, 100)), expr_codes=rng.normal(0, 1, (B, 79)))
    args = {k: v.astype(np.float32) if v.dtype != bool else v for k, v in args.items()}
    got = Loss.NL3DMMLoss(b.skinmask).calc_total_loss(
        **{k: torch.from_numpy(v) for k, v in args.items()}, lm_w=25.0)
    want = JLoss.NL3DMMLoss(np.asarray(jb.skinmask)).calc_total_loss(
        **{k: jnp.asarray(v) for k, v in args.items()}, lm_w=25.0)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=OUT_TOL, err_msg=k)
    np.testing.assert_array_equal(Loss.make_lm_weights(), JLoss.make_lm_weights())
    d, t = rng.normal(0, 1, (B, 3)).astype(np.float32), rng.normal(0, 1, (B, 3)).astype(np.float32)
    np.testing.assert_allclose(float(Loss.regu_cam_offset_loss(*_t(d, t))),
                               float(JLoss.regu_cam_offset_loss(jnp.asarray(d), jnp.asarray(t))),
                               rtol=OUT_TOL)
    angles = rng.normal(0, 0.5, (4, 3)).astype(np.float32)
    np.testing.assert_allclose(Fit.compute_rotation_ref(*_t(angles)).numpy(),
                               np.asarray(JFit.compute_rotation_ref(jnp.asarray(angles))),
                               rtol=0, atol=1e-6)


def _fitters(bases, cfg, raster):
    jb, b = bases
    jf = JFit.NL3DMMFitter(jb, cfg, raster)
    tf = Fit.NL3DMMFitter(b, Fit.FitConfig(*cfg), R.RasterSettings(*raster),
                          decoder_params=geometry_decoder_params_from_jax(jf.decoder_params),
                          device="cpu")
    return jf, tf


def _target(jb, raster, B):
    Rm, T, K = _camera(B, focal=100.0 * raster.image_size / 128, size=raster.image_size)
    verts = jnp.broadcast_to(jb.mean_shape[None], (B, 256, 3))
    target, _ = JR.render_mesh(verts, jnp.full((B, 256, 3), 0.55), jb.triangles,
                               *map(jnp.asarray, (Rm, T, K)), raster)
    lms = JR.project_landmarks(verts, jb.landmark_index, *map(jnp.asarray, (Rm, T, K)))
    T_off = T + np.array([[0.08, -0.05, 0.2]], np.float32)
    return np.asarray(target), np.asarray(lms), Rm, T_off, K


def test_fit_two_plus_two_steps_matches_jax(bases):
    """Two camera-only steps and two with the codes (B=2, 64^2): the losses
    within FIT_LOSS_RTOL, the codes and every camera output within
    FIT_REL_L2; stage 1 leaves the codes at their start."""
    raster = JR.RasterSettings(image_size=64, tile_size=16, tris_per_tile=32)
    jf, tf = _fitters(bases, JFit.FitConfig(stage1_steps=2, stage2_steps=2, image_size=64), raster)
    args = _target(bases[0], raster, 2)
    want, got = jf.fit(*args), tf.fit(*args)
    assert set(got) == set(want)
    for k in ("stage1_losses", "stage2_losses"):
        np.testing.assert_allclose(got[k], want[k], rtol=FIT_LOSS_RTOL, err_msg=k)
    for k in ("code", "w2c_Rmat", "w2c_Tvec", "c2w_Rmat", "c2w_Tvec"):
        assert got[k].dtype == want[k].dtype and rel(got[k], want[k]) <= FIT_REL_L2, k
    for k in ("inmat", "inv_inmat"):
        np.testing.assert_array_equal(got[k], want[k])
    stage1 = Fit.NL3DMMFitter(bases[1], Fit.FitConfig(stage1_steps=2, stage2_steps=0,
                                                      image_size=64),
                              R.RasterSettings(*raster), device="cpu").fit(*args)
    np.testing.assert_array_equal(stage1["code"][:, 279:], F.init_illu_code(2).numpy())
    assert not stage1["code"][:, :279].any() and stage1["stage2_losses"].shape == (0,)


def test_fit_twenty_plus_thirty_steps_matches_jax(bases):
    """JAX's own fitting test (``tests/test_preprocess.py``): from a
    translated base camera toward a rendered target, 20 + 30 steps at lr
    3e-3; both loss curves fall and agree within CURVE_RTOL; the fitted
    rotation stays a rotation."""
    raster = JR.RasterSettings(image_size=64, tile_size=16, tris_per_tile=32)
    cfg = JFit.FitConfig(stage1_steps=20, stage2_steps=30, image_size=64, lr_cam=3e-3)
    jf, tf = _fitters(bases, cfg, raster)
    args = _target(bases[0], raster, 1)
    want, got = jf.fit(*args), tf.fit(*args)
    curve = np.concatenate([got["stage1_losses"], got["stage2_losses"]])
    jcurve = np.concatenate([want["stage1_losses"], want["stage2_losses"]])
    assert np.isfinite(curve).all() and curve[-1] < curve[0] and jcurve[-1] < jcurve[0]
    np.testing.assert_allclose(curve, jcurve, rtol=CURVE_RTOL)
    np.testing.assert_allclose(got["w2c_Rmat"][0] @ got["c2w_Rmat"][0], np.eye(3), atol=1e-5)


def test_render_fit_matches_jax(bases):
    """The QA re-render of a finished fit (zero offsets over the fitted
    cameras)."""
    raster = JR.RasterSettings(image_size=64, tile_size=16, tris_per_tile=32)
    jf, tf = _fitters(bases, JFit.FitConfig(image_size=64), raster)
    Rm, T, K = _camera(2, focal=50.0, size=64)
    res = {"code": np.random.default_rng(2).normal(0, 0.3, (2, 306)).astype(np.float32),
           "w2c_Rmat": Rm, "w2c_Tvec": T, "inmat": K}
    for g, w in zip(tf.render_fit(res), jf.render_fit(res)):
        assert rel(g, w) <= OUT_TOL


def test_loaders_round_trip(tmp_path, bases):
    """``load_basis`` (one npz), ``load_basis_pkl`` (upstream's pickle, the
    topology npz, ``LandMarkInfo.pkl``, ``skinmask.npy``), ``load_topology``
    and ``geometry_decoder_params_from_torch`` (upstream's names under a
    prefix, through ``torch.save``) on files written here, against JAX's
    loaders."""
    jb, b = bases
    npz = tmp_path / "basis.npz"
    np.savez(npz, **{k: np.asarray(getattr(jb, k)) for k in jb._fields})
    for name, x, y in zip(F.BasisData._fields, F.load_basis(str(npz)), JF.load_basis(str(npz))):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=name)
    rng = np.random.default_rng(3)
    V, Ds, Dt = 40, 179, 100
    d = {"mu": rng.standard_normal(3 * V), "b": rng.standard_normal((Ds, 3 * V)),
         "sig_id": rng.random(100), "sig_exp": rng.random(79), "mu_tex": rng.random(3 * V),
         "b_tex": rng.standard_normal((Dt, 3 * V)), "sig_tex": rng.random(Dt)}
    d = {k: v.astype(np.float32) for k, v in d.items()}
    pkl, topo = tmp_path / "nl3dmm_dict.pkl", tmp_path / "topo.npz"
    pickle.dump(d, open(pkl, "wb"))
    fv = rng.integers(0, V, (70, 3)).astype(np.int32)
    fv[0] = [V - 1, 0, 1]
    np.savez(topo, fv_indices=fv, corr_vf_indices=rng.integers(0, 71, (V, 8)).astype(np.int32))
    lmk, skin = tmp_path / "LandMarkInfo.pkl", tmp_path / "skinmask.npy"
    pickle.dump(rng.choice(V, 68), open(lmk, "wb"))
    np.save(skin, (rng.random(V) > 0.5).astype(np.float32))
    for kw in ({}, {"topo_npz_path": str(topo), "landmark_pkl_path": str(lmk),
                    "skinmask_npy_path": str(skin)}):
        got, want = F.load_basis_pkl(str(pkl), **kw), JF.load_basis_pkl(str(pkl), **kw)
        for name, x, y in zip(F.BasisData._fields, got, want):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=name)
    for x, y in zip(F.load_topology(str(topo)), JF.load_topology(str(topo))):
        np.testing.assert_array_equal(x, y)
    dec = F.GeometryDecoder(b, hidden=256, seed=3)
    path = tmp_path / "nl3dmm_net_dict.pth"
    torch.save({"net": {f"module.nl3dmm.{k}": v for k, v in dec.state_dict().items()}}, path)
    sd = torch.load(path)["net"]
    loaded = F.geometry_decoder_params_from_torch(sd)
    jparams = JF.geometry_decoder_params_from_torch({k: v.numpy() for k, v in sd.items()})
    for k, v in dec.state_dict().items():
        np.testing.assert_array_equal(loaded[k].numpy(), v.numpy(), err_msg=k)
    for k, v in geometry_decoder_params_from_jax(jparams).items():
        np.testing.assert_array_equal(v.numpy(), dec.state_dict()[k].numpy(), err_msg=k)
    with pytest.raises(KeyError, match="geo_fc"):
        F.geometry_decoder_params_from_torch({"geo_fc2.weight": np.zeros(1)})
