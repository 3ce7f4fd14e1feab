"""The port's ReSTIR against the JAX package, on seeded numpy inputs.

The reservoir functions of `ops/restir.py` against `raytracer0_tpu.ops.
restir` one by one; `reservoir_direct` on the same vertices and the same
reservoir ring; `render_sample`, the plain version of the fused kernel K6,
against JAX's `render_sample` on `restir_demo` at passes 0-3 (each pass fed
the JAX ring through `Reservoirs.from_arrays`; temporal reuse starts at
pass 3) and on one pass of `restir_stress` (41 lights: 4 spatial taps);
then the gates (K1 refuses ReSTIR, K6's gate states the JAX
`supported_restir_fused` class, K2's gate refuses SDF meshes and ReSTIR, a
gradient through a ReSTIR pass raises) and a render through the Renderer.

The JAX references run op by op (`jax.disable_jit`): compiled, XLA
contracts a*b + c into FMAs, which the port and its kernels do not (see
tests/test_torch_sdf.py).  The pass contract is JAX's own
fused-versus-wavefront contract (tests/test_restir.py:312-352): max |Δ| <
5e-3 and median |Δ| < 1e-6 of the radiance, light indices agreeing at >=
99.5 % of pixels, and where they agree the other fields within 1e-4 plus
1e-4 of their size.  That relative term is needed across frameworks: on
the same vertices the two pipelines agree to 5e-7, but a second-bounce
vertex an ULP apart (torch's and XLA's CPU sin/cos/sqrt differ by an ULP
on some inputs) can move a near-grazing target value, and once moved w by
3.3e-4 at w = 3.42 (9.7e-5 of it).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracer0_tpu import rng as jrng
from raytracer0_tpu.models import camera as jcam
from raytracer0_tpu.models import presets as jpresets
from raytracer0_tpu.ops import intersect as jisect
from raytracer0_tpu.ops import restir as jrestir
from raytracer0_tpu.ops import sdf as jsdf
from raytracer0_tpu.render.state import RenderState as JState
from raytracer0_tpu_torch import rng as trng
from raytracer0_tpu_torch.models import presets as tpresets
from raytracer0_tpu_torch.ops import megakernel as tmk
from raytracer0_tpu_torch.ops import restir as trestir
from raytracer0_tpu_torch.ops import restir_kernel as tk6
from raytracer0_tpu_torch.render.renderer import Renderer, render_pass
from raytracer0_tpu_torch.render.state import RESERVOIR_FIELDS, RenderState, Reservoirs

# pytest-xdist runs the test files in worker processes that share the
# cores: one torch thread each, or their intra-op pools oversubscribe them
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

T = torch.from_numpy
H, W = 8, 128
FIELDS = tuple(RESERVOIR_FIELDS)


def _cfg(cfg, **kw):
    # remat_bounces only steers JAX's autodiff memory; off, its op-by-op run
    # compiles each op once for the whole module (the port reads no such field)
    return cfg.replace(max_bounces=2, max_diff_bounces=2, restir_samples=4,
                       marching_steps=16, remat_bounces=False, **kw)


def _port_ring(jstate):
    conv = lambda r: Reservoirs.from_arrays({k: np.asarray(getattr(r, k)) for k in FIELDS},
                                            "cpu")
    return RenderState.create(H, W, "cpu").replace(
        restir_back=conv(jstate.restir_back), restir_hist1=conv(jstate.restir_hist1),
        restir_hist2=conv(jstate.restir_hist2))


@pytest.fixture(scope="module")
def jax_passes():
    """JAX render_sample on restir_demo, passes 0-3 at 8x128, op by op:
    [(ring before the pass, radiance, new back reservoirs)]."""
    js, jc, cfg = jpresets.restir_demo()
    cfg = _cfg(cfg)
    state, out = JState.create(H, W), []
    with jax.disable_jit():
        for p in range(4):
            rad, nb = jrestir.render_sample(js, cfg, jc, state, H, W, p)
            out.append((state, np.asarray(rad), {k: np.asarray(getattr(nb, k)) for k in FIELDS}))
            state = state.rotate_reservoirs(nb)
    return out


def _pass_contract(rad, new, ref_rad, ref_new):
    err = np.abs(rad - ref_rad)
    n_diff = int((err.max(axis=-1) > 0).sum())
    agree = new["light_index"] == ref_new["light_index"]
    print(f"max |Δ| {err.max():.3e}, median {np.median(err):.3e}, {n_diff} pixels differ, "
          f"light index agrees at {agree.mean():.4f}")
    assert err.max() < 5e-3 and np.median(err) < 1e-6
    assert agree.mean() >= 0.995
    for k in FIELDS:
        if k != "light_index":
            np.testing.assert_allclose(new[k][agree], ref_new[k][agree], rtol=1e-4, atol=1e-4,
                                       err_msg=k)


@pytest.mark.parametrize("p", range(4))
def test_render_sample_matches_jax(jax_passes, p):
    """restir.render_sample against JAX's on restir_demo, pass p, on the
    JAX ring of that pass."""
    state, ref_rad, ref_new = jax_passes[p]
    ts, tc, cfg = tpresets.restir_demo(device="cpu")
    rad, new = trestir.render_sample(ts, _cfg(cfg), tc, _port_ring(state), H, W, p)
    assert tuple(rad.shape) == (H, W, 3) and bool(torch.isfinite(rad).all())
    _pass_contract(rad.numpy(), {k: v.numpy() for k, v in new.fields().items()},
                   ref_rad, ref_new)
    assert (ref_new["light_index"] >= 0).mean() > 0.9
    if p == 3:  # temporal reuse has run: merged reservoirs carry M > 1
        assert ref_new["m"].max() > 4.0


def test_render_sample_stress_matches_jax():
    """One pass of restir_stress (41 lights, so 4 spatial taps)."""
    js, jc, cfg = jpresets.restir_stress()
    cfg = cfg.replace(max_bounces=2, restir_samples=8, marching_steps=16, remat_bounces=False)
    with jax.disable_jit():
        ref_rad, nb = jrestir.render_sample(js, cfg, jc, JState.create(H, W), H, W, 0)
    ts, tc, _ = tpresets.restir_stress(device="cpu")
    rad, new = trestir.render_sample(ts, cfg, tc, RenderState.create(H, W, "cpu"), H, W, 0)
    _pass_contract(rad.numpy(), {k: v.numpy() for k, v in new.fields().items()},
                   np.asarray(ref_rad), {k: np.asarray(getattr(nb, k)) for k in FIELDS})


def test_render_sample_mis_matches_jax():
    """restir_demo with MIS (9 lights, so ReSTIR stays engaged and the
    emissive hits of diffuse paths take the BSDF-side MIS weight), one pass,
    against JAX's render_sample: the class K6's gate admits with MIS is held
    here, by the host build (tests/test_torch_kernel_host.py) and on the
    card (chip_smoke.py phase 16)."""
    js, jc, cfg = jpresets.restir_demo(use_mis=True)
    cfg = _cfg(cfg)
    with jax.disable_jit():
        ref_rad, nb = jrestir.render_sample(js, cfg, jc, JState.create(H, W), H, W, 1)
    ts, tc, _ = tpresets.restir_demo(device="cpu", use_mis=True)
    assert tk6.unsupported_restir(ts, cfg) is None
    rad, new = trestir.render_sample(ts, cfg, tc, RenderState.create(H, W, "cpu"), H, W, 1)
    _pass_contract(rad.numpy(), {k: v.numpy() for k, v in new.fields().items()},
                   np.asarray(ref_rad), {k: np.asarray(getattr(nb, k)) for k in FIELDS})
    nee = trestir.render_sample(ts, cfg.replace(use_mis=False), tc,
                                RenderState.create(H, W, "cpu"), H, W, 1)[0]
    assert (rad - nee).abs().max().item() > 1e-4   # MIS changes the emissive hits


def test_k6_gate_after_fault_10():
    """K6's gate (and so K7's) admits restir_demo with MIS, which the tests
    hold, and refuses the class no test holds K6 to: a cubemap under
    ReSTIR (ROADMAP queue 1 item 11).  Blended textures, held since K4 and
    K6v were held on them (tests/test_torch_restir_sdf.py), K6 admits, and
    K7 too in its whole-SDF copy, held since it replays the texel
    (tests/test_torch_kernel_host_restir_sdf.py); the plain version renders
    both on the CPU."""
    demo, _, cfg = tpresets.restir_demo(device="cpu")
    assert tk6.unsupported_restir(demo, cfg.replace(use_mis=True)) is None
    assert tk6.unsupported_restir_bwd(demo, cfg.replace(use_mis=True)) is None
    from raytracer0_tpu_torch.models.materials import SdfShape
    from raytracer0_tpu_torch.render import integrator as tint
    back_wall = "MAT_WHITE, PLANE, vec3(0.0, 0.0, 1.0)"
    assert back_wall in tpresets._RESTIR_9_LIGHTS
    textured = tpresets.parse_scene(
        tpresets._RESTIR_9_LIGHTS.replace(back_wall, "MAT_CHECK_WHITE, PLANE, vec3(0.0, 0.0, 1.0)"),
        sdf_shapes=[SdfShape.ROUND_BOX], device="cpu")
    assert tk6.unsupported_restir(textured, cfg) is None
    assert tk6.unsupported_restir_bwd(textured, cfg) is None
    assert tk6.bwd_copy(textured) == "whole_sdf" and tk6.bwd_copy(demo) == "round_box"
    cube_cfg = cfg.replace(use_cubemap=True, use_procedural_sky=False)
    assert "cubemap" in tk6.unsupported_restir(demo, cube_cfg)
    assert "item 11" in tk6.unsupported_restir(demo, cube_cfg)
    assert tint.unsupported(demo, cube_cfg) is None and tint.unsupported(textured, cfg) is None


def test_reservoir_direct_matches_jax(jax_passes):
    """reservoir_direct on the same primary-hit vertices and the same ring
    (pass 3: candidates, temporal and spatial reuse, finalize and shade)
    agrees with JAX's to float32 rounding."""
    state, _, _ = jax_passes[3]
    js, jc, cfg = jpresets.restir_demo()
    cfg = _cfg(cfg)
    ro, rd = jcam.generate_rays(jc, H, W, 3)
    pix = jrng.pixel_ids(H, W)
    with jax.disable_jit():
        hit = jisect.intersect(js, ro, rd, cfg, sdf_march=jsdf.march)
        inside = -jnp.sign(jnp.sum(rd * hit.n, -1))
        nl = hit.n * jnp.where(inside == 0.0, 1.0, inside)[..., None]
        back = jrestir._res_tree(state.restir_back)
        hist = [jrestir._res_tree(state.restir_hist1), jrestir._res_tree(state.restir_hist2)]
        ref_out, ref_res = jrestir.reservoir_direct(js, cfg, back, hist, hit.pos, nl, hit.idx,
                                                    pix, 3, 0, 0, height=H, width=W,
                                                    sdf_march=jsdf.march)
    ring = _port_ring(state)
    ts, _, _ = tpresets.restir_demo(device="cpu")
    out, res = trestir.reservoir_direct(
        ts, cfg, ring.restir_back.fields(),
        [ring.restir_hist1.fields(), ring.restir_hist2.fields()], T(np.array(hit.pos)),
        T(np.array(nl)), T(np.array(hit.idx)).long(), trng.pixel_ids(H, W), 3, 0, 0,
        height=H, width=W)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(res["light_index"].numpy(), np.asarray(ref_res["light_index"]))
    for k in FIELDS:
        np.testing.assert_allclose(res[k].numpy(), np.asarray(ref_res[k]), rtol=0, atol=1e-4,
                                   err_msg=k)
    assert np.abs(np.asarray(ref_out)).max() > 0.0


def test_reservoir_ops_match_jax():
    """evaluate_target, update_reservoir, is_valid_reservoir,
    combine_reservoirs and finalize_reservoir on seeded inputs, valid and
    invalid reservoirs and every material kind among them."""
    r = np.random.default_rng(7)
    n, L = 4096, 9
    f = lambda *s: r.uniform(-1.0, 1.0, s).astype(np.float32)

    def reservoir():
        return dict(light_pos=f(n, 3) * 2.0, light_color=np.abs(f(n, 3)) * 4.0,
                    weight_sum=r.uniform(-0.1, 1100.0, n).astype(np.float32),
                    m=r.uniform(-1.0, 70.0, n).astype(np.float32),
                    w=r.uniform(-0.5, 25.0, n).astype(np.float32),
                    age=r.uniform(-1.0, 40.0, n).astype(np.float32),
                    light_index=r.integers(-1, L + 1, n).astype(np.int32))

    x, nl = f(n, 3), f(n, 3)
    nl /= np.linalg.norm(nl, axis=-1, keepdims=True)
    mat_c = np.abs(f(n, 3))
    mat_nt = r.uniform(0.0, 2.0, n).astype(np.float32)
    mat_ty = r.choice([2, 3, 4, 5, 6], n).astype(np.int32)
    rand = r.random(n).astype(np.float32)
    tgt, src = reservoir(), reservoir()
    J = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    Tt = lambda d: {k: T(v.copy()) for k, v in d.items()}
    geo = (x, nl, mat_c, mat_nt, mat_ty)

    def close(got, want, **tol):
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k,
                                       **(tol or dict(rtol=1e-6, atol=1e-6)))

    with jax.disable_jit():
        jt = jrestir.evaluate_target(src["light_pos"], src["light_color"], *geo)
        ju = jrestir.update_reservoir(J(tgt), src["light_pos"], src["light_color"],
                                      src["light_index"], np.asarray(jt), rand)
        jv = jrestir.is_valid_reservoir(J(src), L)
        jc = jrestir.combine_reservoirs(J(tgt), J(src), *geo, rand, L)
        vis = r.random(n) < 0.8
        jf = jrestir.finalize_reservoir(J(src), *geo, vis)
    tgeo = tuple(T(a.copy()) for a in geo)
    tt = trestir.evaluate_target(T(src["light_pos"]), T(src["light_color"]), *tgeo)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6, atol=1e-7)
    assert (np.asarray(jt) > 0).mean() > 0.2
    close(trestir.update_reservoir(Tt(tgt), T(src["light_pos"]), T(src["light_color"]),
                                   T(src["light_index"]), T(np.asarray(jt).copy()), T(rand)), ju)
    np.testing.assert_array_equal(trestir.is_valid_reservoir(Tt(src), L).numpy(), np.asarray(jv))
    assert 0.02 < np.asarray(jv).mean() < 0.9
    close(trestir.combine_reservoirs(Tt(tgt), Tt(src), *tgeo, T(rand), L), jc)
    close(trestir.finalize_reservoir(Tt(src), *tgeo, T(vis)), jf)


def test_gates():
    """K1 refuses ReSTIR in its own words; K6's gate admits the ReSTIR
    presets and refuses what the JAX `supported_restir_fused` refuses;
    K2's gate admits the BOX SDF of `mis_demo` (its wide copy) and
    refuses ReSTIR (K7, item 11)."""
    demo, _, cfg = tpresets.restir_demo(device="cpu")
    stress, _, scfg = tpresets.restir_stress(device="cpu")
    assert "K6" in tmk.unsupported(demo, cfg) and "item 11" in tmk.unsupported(demo, cfg)
    assert tk6.unsupported_restir(demo, cfg) is None
    assert tk6.unsupported_restir(stress, scfg) is None
    cornell, _, ccfg = tpresets.cornell_default(device="cpu")
    cube, _, cube_cfg = tpresets.cubemap_demo(device="cpu")
    refused = [
        (demo, cfg.replace(use_restir=False), "not a ReSTIR config"),
        (cornell, ccfg.replace(use_restir=True, use_mis=True), "per-light NEE"),
        (demo, cfg.replace(restir_adhoc_motion=True), "ad-hoc"),
        (cube, cube_cfg.replace(use_restir=True), "photographic cubemap"),
        (demo, cfg.replace(use_biased_sampling=False), "uniform"),
        (demo, cfg.replace(use_volumetrics=True), "item 10"),
    ]
    for scene, c, words in refused:
        assert words in tk6.unsupported_restir(scene, c), words
    sun = tpresets.parse_scene("""
        MAT_WHITE, PLANE, vec3(0.0, 1.0, 0.0), vec4(2.0)
        MAT_DIRECT_SUNLIGHT, SPHERE, vec3(0.5, 0.8, 0.3), vec4(0.01)
    """, device="cpu", lights=[1])
    assert "not LIGHT spheres" in tk6.unsupported_restir(sun, cfg)
    mis, _, mcfg = tpresets.mis_demo(device="cpu")
    assert tmk.unsupported(mis, mcfg) is None
    assert tmk.unsupported_bwd(mis, mcfg) is None and not tmk.cornell_copy(mis, mcfg)
    restir_bwd = tmk.unsupported_bwd(cornell, ccfg.replace(use_restir=True))
    assert "K7" in restir_bwd and "item 11" in restir_bwd


def test_gradient_through_restir_raises():
    """A ReSTIR pass with a leaf that requires a gradient, which raised
    before K7, now differentiates on the CPU through render_sample and
    render_pass (plain autograd); the kernels' wrapper refuses, before any
    launch, a gradient K7 does not compute: the aux leaf, whose column the
    ROUND_BOX copy restir_demo runs does not keep, a texel array (the
    images, item 14), and a BOX row in a scene K4 and K6v march without the
    whole SDF class (item 8)."""
    scene, cam, cfg = tpresets.restir_demo(device="cpu")
    cfg = _cfg(cfg)
    state = RenderState.create(4, 8, "cpu")
    em = scene.emission.clone().requires_grad_(True)
    rad, _ = trestir.render_sample(scene.replace(emission=em), cfg, cam, state, 4, 8, 0)
    g = torch.autograd.grad(rad.sum(), em)[0]
    assert bool(torch.isfinite(g).all()) and bool((g != 0).any())
    out = render_pass(scene.replace(emission=em), cam, cfg, state, 4, 8)
    assert out.passes == 1 and out.accum.requires_grad
    from raytracer0_tpu_torch import rng as trng_mod
    from raytracer0_tpu_torch.models.camera import generate_rays
    ro, rd = generate_rays(cam, 4, 8, 0)
    pix = trng_mod.pixel_ids(4, 8)
    before = (tk6.LAUNCHES, tk6.BWD_LAUNCHES)
    aux = scene.aux.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="K7.*aux.*ROUND_BOX copy"):
        tk6._fused(scene.replace(aux=aux), cfg, ro, rd, pix, 0, 0, state.restir_back,
                   state.restir_hist1, state.restir_hist2)
    images = scene.replace(images=scene.images.clone().requires_grad_(True), emission=em)
    with pytest.raises(NotImplementedError, match="K7.*images.*item 14"):
        tk6._fused(images, cfg, ro, rd, pix, 0, 0, state.restir_back, state.restir_hist1,
                   state.restir_hist2)
    box = scene.replace(sdf_shapes_static=(0,), emission=em)
    with pytest.raises(NotImplementedError, match="K7.*ROUND_BOX.*item 8"):
        tk6._fused(box, cfg, ro, rd, pix, 0, 0, state.restir_back, state.restir_hist1,
                   state.restir_hist2)
    assert (tk6.LAUNCHES, tk6.BWD_LAUNCHES) == before


def test_renderer_restir_against_nee():
    """Renderer(restir_demo) on the CPU: the ring rotates by reference,
    the reservoirs fill (M > 0, W within its clamp, some pixels hold a
    light), and the image's mean lies between 1/9 and 2x of the per-light
    NEE render's (the JAX check, tests/test_restir.py:94-129: ReSTIR's
    weights omit the 1/L candidate pdf)."""
    scene, cam, cfg = tpresets.restir_demo(device="cpu", max_bounces=3, restir_samples=8,
                                           marching_steps=32)
    r = Renderer(scene, cam, cfg, 32, 32)
    r.step()
    back = r.state.restir_back
    r.step()
    assert r.state.restir_hist1 is back
    for _ in range(4):
        r.step()
    res = r.state.restir_back
    assert res.m.max().item() > 0.0 and res.w.max().item() <= 12.0 + 1e-5
    assert res.age.min().item() >= 0.0 and int((res.light_index >= 0).sum()) > 10
    img_restir = r.state.accum / 6
    nee = Renderer(scene, cam, cfg.replace(use_restir=False), 32, 32)
    for _ in range(6):
        nee.step()
    m1, m2 = img_restir.mean().item(), (nee.state.accum / 6).mean().item()
    assert bool(torch.isfinite(img_restir).all()) and m2 > 0.003
    assert 1.0 / 9.0 < m1 / m2 < 2.0, (m1, m2)
