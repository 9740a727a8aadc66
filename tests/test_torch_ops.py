"""The port's render primitives and pose math against the JAX package.

Every case feeds both packages the same seeded numpy inputs and compares
values and gradients in f32, deterministic paths only (key=None /
generator=None).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.ops import aabb as jaabb
from nerf_from_image_tpu.ops import compositing as jcomp
from nerf_from_image_tpu.ops import rays as jrays
from nerf_from_image_tpu.ops import sampling as jsamp
from nerf_from_image_tpu.ops import triplane as jtri
from nerf_from_image_tpu.pose import pose as jpose
from nerf_from_image_tpu_torch.ops import aabb as taabb
from nerf_from_image_tpu_torch.ops import compositing as tcomp
from nerf_from_image_tpu_torch.ops import rays as trays
from nerf_from_image_tpu_torch.ops import sampling as tsamp
from nerf_from_image_tpu_torch.ops import triplane as ttri
from nerf_from_image_tpu_torch.pose import pose as tpose
from tests.test_torch_generator import release_memory  # noqa: F401

TOL = 1e-5


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), dtype=torch.float32, requires_grad=grad)


def _close(a, b, tol=TOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.max(np.abs(b))), 1e-6)
    err = float(np.max(np.abs(a - b))) / scale
    assert err < tol, err


def _cams(rng, B=2):
    mats = []
    for _ in range(B):
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        q *= np.sign(np.linalg.det(q))
        m = np.eye(4)
        m[:3, :3] = q
        m[:3, 3] = q @ np.array([0.0, 0.0, 2.5])
        mats.append(m)
    return np.stack(mats).astype(np.float32)


@pytest.mark.parametrize("ortho,extras", [(False, False), (False, True), (True, True)])
def test_ray_bundle_and_normalize(ortho, extras):
    rng = np.random.default_rng(0)
    cam = _cams(rng)
    if ortho:
        cam[:, 3, 3] = 1.3
    focal = None if ortho else rng.uniform(1.0, 1.5, 2).astype(np.float32)
    bbox = rng.uniform(-0.5, 0.5, (2, 2, 2)).astype(np.float32) if extras else None
    center = rng.uniform(0.4, 0.6, (2, 2)).astype(np.float32) if extras and not ortho else None
    jo, jd = jrays.get_ray_bundle(6, 5, None if ortho else jnp.asarray(focal),
                                  jnp.asarray(cam), bbox, center)
    to, td = trays.get_ray_bundle(6, 5, None if ortho else _t(focal), _t(cam),
                                  None if bbox is None else _t(bbox),
                                  None if center is None else _t(center))
    _close(to, jo)
    _close(td, jd)
    _close(trays.normalize_directions(td), jrays.normalize_directions(jd))


def test_near_far_planes_with_miss_rays_and_no_gradient():
    rng = np.random.default_rng(1)
    o = rng.uniform(-3, 3, (2, 7, 3)).astype(np.float32)
    d = rng.standard_normal((2, 7, 3)).astype(np.float32)
    d[0, 0] = [0.0, 0.0, -1.0]  # axis-aligned: infinite inverse directions
    jn, jf = jaabb.compute_near_far_planes(jnp.asarray(o), jnp.asarray(d), 1.4)
    assert not bool(jnp.all(jn == jn[0, 0]))
    to, td = _t(o, True), _t(d, True)
    tn, tf = taabb.compute_near_far_planes(to, td, 1.4)
    _close(tn, jn)
    _close(tf, jf)
    assert not tn.requires_grad and not tf.requires_grad
    jg = jax.grad(lambda o: jnp.sum(jaabb.compute_near_far_planes(o, jnp.asarray(d), 1.4)[0]))(
        jnp.asarray(o))
    assert float(jnp.max(jnp.abs(jg))) == 0.0


def test_query_points_and_sample_pdf():
    rng = np.random.default_rng(2)
    o = rng.standard_normal((2, 3, 4, 3)).astype(np.float32)
    d = rng.standard_normal((2, 3, 4, 3)).astype(np.float32)
    near = rng.uniform(0.5, 1.0, (2, 3, 4)).astype(np.float32)
    far = near + rng.uniform(1.0, 2.0, (2, 3, 4)).astype(np.float32)

    def jfn(o, d):
        p, z = jsamp.compute_query_points_from_rays(o, d, jnp.asarray(near), jnp.asarray(far), 8)
        return jnp.sum(jnp.sin(p)), (p, z)

    (_, (jp, jz)), (jgo, jgd) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(o), jnp.asarray(d))
    to, td = _t(o, True), _t(d, True)
    tp, tz = tsamp.compute_query_points_from_rays(to, td, _t(near), _t(far), 8)
    torch.sum(torch.sin(tp)).backward()
    _close(tp, jp)
    _close(tz, jz)
    _close(to.grad, jgo)
    _close(td.grad, jgd)

    # Per-batch near/far broadcast over the pixel grid.
    jp2, _ = jsamp.compute_query_points_from_rays(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(near[:, 0, 0]), jnp.asarray(far[:, 0, 0]), 5)
    tp2, _ = tsamp.compute_query_points_from_rays(
        _t(o), _t(d), _t(near[:, 0, 0]), _t(far[:, 0, 0]), 5)
    _close(tp2, jp2)

    bins = np.sort(rng.uniform(0, 4, (30, 10)), axis=-1).astype(np.float32)
    w = rng.uniform(0, 1, (30, 9)).astype(np.float32)
    w[:5] = 0.0  # flat weights: the 1e-5 floor decides
    w[5:10, 3] = 50.0  # a peaked pdf
    _close(tsamp.sample_pdf(_t(bins), _t(w), 16),
           jsamp.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 16))


def _composite_inputs(rng, S=6):
    shape = (2, 3, 4)
    sa = rng.uniform(0, 3, shape + (S,)).astype(np.float32)
    sb = rng.uniform(0, 3, shape + (S,)).astype(np.float32)
    da = np.sort(rng.uniform(1, 3, shape + (S,)), axis=-1).astype(np.float32)
    db = rng.uniform(1, 3, shape + (S,)).astype(np.float32)
    db[..., 2] = da[..., 3]  # ties between the lists: a is ordered first
    db = np.sort(db, axis=-1)
    ca = rng.uniform(-1, 1, shape + (S, 3)).astype(np.float32)
    cb = rng.uniform(-1, 1, shape + (S, 3)).astype(np.float32)
    dirs = rng.standard_normal(shape + (3,)).astype(np.float32)
    return sa, da, ca, sb, db, cb, dirs


def test_composite_dual_matches_jax_and_sort_merge():
    sa, da, ca, sb, db, cb, dirs = _composite_inputs(np.random.default_rng(3))
    wr = np.random.default_rng(4).standard_normal((2, 3, 4, 3)).astype(np.float32)

    def jfn(sa, ca, sb, cb, dirs):
        out = jcomp.composite_dual(sa, jnp.asarray(da), {"rgb": ca}, sb, jnp.asarray(db),
                                   {"rgb": cb}, dirs, white_background=True)
        return jnp.sum(out.rgb * wr) + jnp.sum(out.mask ** 2), out

    args = [jnp.asarray(x) for x in (sa, ca, sb, cb, dirs)]
    (_, jout), jgrads = jax.jit(jax.value_and_grad(jfn, argnums=tuple(range(5)),
                                                   has_aux=True))(*args)

    def tfn(merge):
        targs = [_t(x, True) for x in (sa, ca, sb, cb, dirs)]
        tsa, tca, tsb, tcb, tdirs = targs
        if merge == "pairwise":
            out = tcomp.composite_dual(tsa, _t(da), {"rgb": tca}, tsb, _t(db),
                                       {"rgb": tcb}, tdirs, white_background=True)
        else:  # concatenate, stable depth sort, composite
            depth = torch.cat((_t(da), _t(db)), dim=-1)
            order = torch.argsort(depth, dim=-1, stable=True)
            sig = torch.take_along_dim(torch.cat((tsa, tsb), -1), order, -1)
            col = torch.take_along_dim(torch.cat((tca, tcb), -2), order[..., None], -2)
            out = tcomp.render_volume_density(sig, col, tdirs,
                                              torch.take_along_dim(depth, order, -1))
        (torch.sum(out.rgb * _t(wr)) + torch.sum(out.mask ** 2)).backward()
        return out, [t.grad for t in targs]

    for merge in ("pairwise", "sort"):
        tout, tgrads = tfn(merge)
        for name in ("rgb", "depth", "mask"):
            _close(getattr(tout, name), getattr(jout, name))
        for tg, jg in zip(tgrads, jgrads):
            _close(tg, jg, 1e-4)


def test_render_volume_density_weights_and_smoothing():
    rng = np.random.default_rng(5)
    sigma = rng.uniform(0, 3, (2, 3, 8)).astype(np.float32)
    rgb = rng.uniform(-1, 1, (2, 3, 8, 3)).astype(np.float32)
    normals = rng.standard_normal((2, 3, 8, 3)).astype(np.float32)
    depth = np.sort(rng.uniform(1, 3, (2, 3, 8)), axis=-1).astype(np.float32)
    dirs = rng.standard_normal((2, 3, 3)).astype(np.float32)

    def jfn(sigma, rgb, normals):
        out = jcomp.render_volume_density(sigma, rgb, jnp.asarray(dirs), jnp.asarray(depth),
                                          normals, white_background=True)
        return jnp.sum(out.rgb) + jnp.sum(out.normals ** 2) + jnp.sum(out.mask), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(sigma), jnp.asarray(rgb), jnp.asarray(normals))
    ts, tr, tn = _t(sigma, True), _t(rgb, True), _t(normals, True)
    tout = tcomp.render_volume_density(ts, tr, _t(dirs), _t(depth), tn, white_background=True)
    (torch.sum(tout.rgb) + torch.sum(tout.normals ** 2) + torch.sum(tout.mask)).backward()
    for name in ("rgb", "depth", "mask", "normals"):
        _close(getattr(tout, name), getattr(jout, name))
    for tg, jgi in zip((ts.grad, tr.grad, tn.grad), jg):
        _close(tg, jgi, 1e-4)

    w_j = jcomp.render_volume_density_weights_only(jnp.asarray(sigma), jnp.asarray(dirs),
                                                   jnp.asarray(depth))
    w_t = tcomp.render_volume_density_weights_only(_t(sigma), _t(dirs), _t(depth))
    _close(w_t, w_j)
    _close(tcomp.smooth_weights(w_t.reshape(-1, 8)), jcomp.smooth_weights(w_j.reshape(-1, 8)))


@pytest.mark.parametrize("dt,tol", [(None, TOL), ("bfloat16", 2e-2)])
def test_pack_corners_and_sample_packed(dt, tol):
    rng = np.random.default_rng(6)
    plane = rng.standard_normal((2, 9, 7, 5)).astype(np.float32)
    coords = rng.uniform(-1.1, 1.1, (2, 40, 2)).astype(np.float32)
    coords[:, :4] = [[1.0, -1.0], [-1.0, 1.0], [1.0, 0.3], [0.2, -1.0]]
    wsum = rng.standard_normal((2, 40, 5)).astype(np.float32)

    def jfn(plane, coords):
        p = plane.astype(dt) if dt else plane
        e = jtri.sample_packed(jtri.pack_corners(p), coords)
        return jnp.sum(e * wsum), e

    (_, je), (jgp, jgc) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(plane), jnp.asarray(coords))
    tp, tc = _t(plane, True), _t(coords, True)
    packed = ttri.pack_corners(tp.to(getattr(torch, dt)) if dt else tp)
    _close(packed.float(), jtri.pack_corners(jnp.asarray(plane)), tol)
    te = ttri.sample_packed(packed, tc)
    torch.sum(te * _t(wsum)).backward()
    _close(te, je, tol)
    _close(tp.grad, jgp, tol)
    _close(tc.grad, jgc, tol)
    c3 = rng.standard_normal((3, 4, 3)).astype(np.float32)
    for a, b in zip(ttri.plane_coords(_t(c3)), jtri.plane_coords(jnp.asarray(c3))):
        _close(a, b)


@pytest.mark.parametrize("flipped,ortho", [(False, False), (True, False), (False, True)])
def test_pose_round_trip_and_gradients(flipped, ortho):
    rng = np.random.default_rng(7)
    cam = _cams(rng, B=3)
    cam[2, :3, :3] = np.diag([-1.0, -1.0, 1.0]) @ cam[2, :3, :3]  # another Shepperd branch
    cam[:, 3, 3] = 1.2 if ortho else 1.0
    focal = None if ortho else np.array([1.1, 1.3, 2.0], np.float32)
    jp = jpose.matrix_to_pose(jnp.asarray(cam), None if ortho else jnp.asarray(focal), flipped)
    tp = tpose.matrix_to_pose(_t(cam), None if ortho else _t(focal), flipped)
    for a, b in zip(tp, jp):
        if b is None:
            assert a is None
        else:
            _close(a, b)
    _close(tpose.invert_space(_t(cam)), jpose.invert_space(jnp.asarray(cam)))
    _close(tpose.matrix_to_quaternion(_t(cam[0])), jpose.matrix_to_quaternion(jnp.asarray(cam[0])))

    z0, t2, s, q = [None if x is None else np.asarray(x) for x in jp]
    wm = rng.standard_normal((3, 4, 4)).astype(np.float32)

    def jfn(t2, s, q, *z0):
        m, f = jpose.pose_to_matrix(z0[0] if z0 else None, t2, s, q, flipped)
        return jnp.sum(m * wm) + (jnp.sum(f) if f is not None else 0.0), m

    leaves = [t2, s, q] + ([] if z0 is None else [z0])
    (_, jm), jg = jax.jit(jax.value_and_grad(jfn, argnums=tuple(range(len(leaves))),
                                             has_aux=True))(*[jnp.asarray(x) for x in leaves])
    tl = [_t(x, True) for x in leaves]
    tm, tf = tpose.pose_to_matrix(tl[3] if z0 is not None else None, tl[0], tl[1], tl[2], flipped)
    (torch.sum(tm * _t(wm)) + (torch.sum(tf) if tf is not None else 0.0)).backward()
    _close(tm, jm)
    if not ortho:  # the perspective round trip recovers the camera
        _close(tm, cam, 1e-4)
    for a, b in zip(tl, jg):
        _close(a.grad, b, 1e-4)
