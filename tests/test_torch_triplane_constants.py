"""The hot path's constants are made once per device and dtype: the
triplane clip's bounds (`ops/triplane.py::clip`), the resampling filter
(`ops/filters.py::bilinear_filter`) and the GAN step's f32 scalars
(`engine/gan.py::_f32`) give the same numbers as the per-call uploads
they replace, first and second derivatives included, and none is
modified by its users. `profile_step --count_syncs`'s counter is checked
on made-up warnings.

The `cuda` test runs a small render (K1's backward) and the resampling
layers under torch.cuda.set_sync_debug_mode("error") and skips without a
card. This file imports no JAX, so it also runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_triplane_constants.py
"""

import warnings

import numpy as np
import pytest
import torch

from nerf_from_image_tpu_torch import profile_step
from nerf_from_image_tpu_torch.engine import gan
from nerf_from_image_tpu_torch.models import layers
from nerf_from_image_tpu_torch.ops import filters, triplane
from nerf_from_image_tpu_torch.utils import device


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread, as every test module of the port runs (the suite
    runs several workers side by side)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def upload_clip(x, lo, hi):
    """The clip as it was: its bounds uploaded from Python numbers on each call."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def upload_filter(dtype, device):
    h = np.array([1.0, 3.0, 3.0, 1.0])
    h = h[:, None] * h[None, :]
    h /= h.sum()
    return torch.as_tensor(h, dtype=dtype, device=device)


def _derivatives(fn, *inputs):
    """fn's value, its first derivatives w.r.t. every input (of a weighted
    sum of the output) and the second derivatives (of the squared first
    ones), as the eikonal and path-length terms take them."""
    inputs = [t.detach().clone().requires_grad_(True) for t in inputs]
    y = fn(*inputs)
    w = torch.linspace(-1.0, 2.0, y.numel(), dtype=torch.float32).reshape(y.shape)
    first = torch.autograd.grad(torch.sum(y.float() * w), inputs, create_graph=True)
    second = torch.autograd.grad(sum(torch.sum(g.float() ** 2) for g in first), inputs,
                                 allow_unused=True)
    return [y, *first, *[s for s in second if s is not None]]


def _assert_same_bits(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(-1), b.view(-1)) and torch.isfinite(a).all(), (a, b)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_clip_matches_the_uploaded_bounds_with_ties(dtype):
    # Points exactly on both bounds (the 0.5 tie), inside and outside.
    x = torch.tensor([-3.0, -1e-3, 0.0, 0.0, 0.25, 63.0, 127.0, 127.0, 127.5, 300.0],
                     dtype=dtype)
    got = _derivatives(lambda t: triplane.clip(t, 0.0, 127.0) ** 2, x)
    want = _derivatives(lambda t: upload_clip(t, 0.0, 127.0) ** 2, x)
    _assert_same_bits(got, want)
    xg = x.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(torch.sum(triplane.clip(xg, 0.0, 127.0)), xg)
    assert g.tolist() == [0.0, 0.0, 0.5, 0.5, 1.0, 1.0, 0.5, 0.5, 0.0, 0.0]


@pytest.mark.parametrize("table_dtype", (torch.float32, torch.bfloat16))
def test_sample_packed_matches_the_uploaded_bounds(monkeypatch, table_dtype):
    gen = torch.Generator().manual_seed(0)
    B, H, W, C, N = 2, 8, 16, 4, 64
    planes = torch.randn((B, H, W, C), generator=gen)
    coords = torch.rand((B, N, 2), generator=gen) * 2.4 - 1.2
    # On the box faces: every clip bound hit exactly, in both axes.
    coords[:, :8] = torch.tensor([[-1.0, -1.0], [1.0, 1.0], [-1.0, 1.0], [1.0, -1.0],
                                  [-1.0, 0.3], [1.0, -0.2], [0.1, -1.0], [0.0, 1.0]])

    def sample(p, c):
        return triplane.sample_packed(triplane.pack_corners(p.to(table_dtype)), c)

    got = _derivatives(sample, planes, coords)
    monkeypatch.setattr(triplane, "clip", upload_clip)
    want = _derivatives(sample, planes, coords)
    _assert_same_bits(got, want)


def test_bounds_are_shared_per_device_dtype_and_value():
    x32 = torch.zeros(3)
    x16 = torch.zeros(3, dtype=torch.bfloat16)
    a = triplane.bound(255.0, x32)
    assert a is triplane.bound(255, x32)
    assert a.dtype == torch.float32 and a.shape == () and a.item() == 255.0
    distinct = [a, triplane.bound(255.0, x16), triplane.bound(127.0, x32),
                triplane.bound(0.0, x32), triplane.bound(-0.0, x32),
                triplane.bound(0.0, torch.zeros(1, dtype=torch.float64))]
    assert len({id(t) for t in distinct}) == len(distinct)
    assert len({t.data_ptr() for t in distinct}) == len(distinct)
    assert [torch.signbit(t).item() for t in distinct[3:5]] == [False, True]
    for value in (0.0, -0.0, 1.0, 127.0, 255.0, 1.0 / 3.0, 1e-8):
        for like in (x32, x16, torch.zeros(1, dtype=torch.float16)):
            _assert_same_bits([triplane.bound(value, like)], [like.new_tensor(value)])
    # Made outside inference mode: autograd can save it later.
    with torch.inference_mode():
        made = triplane.bound(3.5, x32)
    assert not made.is_inference()
    xg = torch.tensor([3.5, 4.0], requires_grad=True)
    (g,) = torch.autograd.grad(torch.sum(triplane.clip(xg, 0.0, 3.5)), xg)
    assert g.tolist() == [0.5, 0.0]


def test_bilinear_filter_is_shared_and_left_unchanged():
    f = filters.bilinear_filter(torch.float32, torch.device("cpu"))
    assert f is filters.bilinear_filter(torch.float32, torch.device("cpu"))
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        _assert_same_bits([filters.bilinear_filter(dtype, torch.device("cpu"))],
                          [upload_filter(dtype, "cpu")])
    assert filters.bilinear_filter(torch.float64, torch.device("cpu")) is not f
    before, version = f.clone(), f._version
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 3, 8, 8), generator=gen, requires_grad=True)
    outs = [filters.upsample2d(x, f), filters.downsample2d(x, f),
            filters.filter2d(x, f, gain=4.0), filters.filter2d(x, f, transpose=True)]
    for up, down in ((True, False), (False, True)):
        conv = layers.EqualizedConv2d(3, 4, 3, activate=True, up=up, down=down)
        conv.init_parameters(gen)
        outs.append(conv(x))
    # Through the double backward too (R1, path length).
    (g,) = torch.autograd.grad(sum(torch.sum(o ** 2) for o in outs), x, create_graph=True)
    torch.autograd.grad(torch.sum(g ** 2), x)
    assert f._version == version
    _assert_same_bits([f], [before])


def test_f32_scalars_have_the_uploaded_bits():
    warmups = (12500, 1000, 3, 7)
    for i in list(range(0, 400)) + [12499, 12500, 12501, 2**24 + 1, 300000]:
        got, want = gan._f32(i, "cpu"), torch.tensor(i, dtype=torch.float32)
        _assert_same_bits([got], [want])
        for n in warmups:
            _assert_same_bits([torch.clamp_max(got / n, 1.0)], [torch.clamp_max(want / n, 1.0)])
    for p in (0.0, 0.1, 0.2, 0.3, 0.6, 0.8, 1.0 / 3.0, 1.0):
        _assert_same_bits([gan._f32(p, "cpu")], [torch.tensor(p, dtype=torch.float32)])
        _assert_same_bits([gan._f32(np.float32(p), "cpu")], [torch.tensor(p, dtype=torch.float32)])


def test_counted_syncs_by_call_site():
    def upload():
        warnings.warn(profile_step.SYNC_WARNING)
        return torch.zeros(())

    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        with profile_step.counted_syncs() as sites:
            for _ in range(3):
                warnings.warn(profile_step.SYNC_WARNING + " (in a test)")
            device.constant(("counted_syncs test", 0), upload)
            warnings.warn("another warning")
    assert sum(sites.values()) == 4
    (here, n), (inside, m) = sites.most_common()
    assert n == 3 and here.split(":")[0].endswith("test_torch_triplane_constants.py")
    # A call that the package made is named by the package's frame first.
    assert m == 1 and inside.startswith("utils/device.py:") and "test_torch_triplane" in inside
    assert [str(w.message) for w in shown] == ["another warning"]


@pytest.mark.cuda
def test_render_and_resampling_do_not_synchronize():
    """After one warm-up call: a small render (checkpointed chunks, K1's
    backward) forward and backward, and the resampling layers' up and
    down paths, under set_sync_debug_mode("error")."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from nerf_from_image_tpu_torch.engine.render import RenderConfig, render
    from nerf_from_image_tpu_torch.kernels import splat
    from nerf_from_image_tpu_torch.models.generator import Generator

    dev = torch.device("cuda")
    model = Generator(latent_dim=64, scene_range=1.4, attention_values=4, use_sdf=True,
                      w_dim=64, plane_channels=32, synthesis_resolution=64,
                      channel_base=2048, channel_max=64, device=dev,
                      generator=torch.Generator().manual_seed(0))
    cfg = RenderConfig(resolution=16, depth_samples_per_ray=8, query_chunk=512,
                       scene_range=1.4, plane_splat=True)
    pose = torch.eye(4, device=dev)[None].repeat(2, 1, 1)
    pose[:, 2, 3] = 2.5
    focal = torch.full((2,), 1.2, device=dev)
    ws0 = torch.randn((2, model.num_ws, 64), generator=torch.Generator(dev).manual_seed(1),
                      device=dev) * 0.1
    gen = torch.Generator().manual_seed(2)
    convs = []
    for up in (True, False):
        conv = layers.EqualizedConv2d(3, 4, 3, activate=True, up=up, down=not up)
        conv.init_parameters(gen)
        convs.append(conv.to(dev))

    def step():
        ws = ws0.clone().requires_grad_(True)
        p = pose.clone().requires_grad_(True)
        out, _ = render(cfg, model, p, focal, ws, device=dev)
        img = out.rgb.permute(0, 3, 1, 2)
        loss = torch.sum(out.rgb ** 2) + torch.sum(out.mask ** 2)
        loss = loss + sum(torch.sum(conv(img) ** 2) for conv in convs)
        return torch.autograd.grad(loss, (ws, p))

    step()
    torch.cuda.synchronize()
    launches = splat.splat3_backward.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        grads = step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert splat.splat3_backward.launches > launches
    assert all(torch.isfinite(g).all() for g in grads)
