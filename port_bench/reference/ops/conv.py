"""2D convolutions that autograd differentiates twice with cuDNN's own
input- and weight-gradient kernels.

The path-length and R1 regularizers of GAN training differentiate a
gradient (engine/regularizers.py, engine/gan.py). Autograd's own double
backward of a convolution computes the weight gradient as a forward
convolution whose filter is the whole output-gradient map (and does so
even for a constant weight); for that shape cuDNN picks a small-tile
kernel that takes hundreds of ms a call at 128^2-256^2. Here the
backward of a convolution is written with convolutions (a transposed
convolution for the input gradient, convolution_backward for the weight
gradient), so the second derivative is ordinary first-order convolution
gradients. Stride and padding are equal in both dimensions, dilation 1,
one group.

A backward computes only the gradients that the running backward pass
uses. `ctx.needs_input_grad` is fixed at the forward, so it would also
compute the weight gradient of a discriminator convolution in a G step
(gradients of G's parameters only) and in the inner gradient of R1 or the
path length (gradients of the images or the latents only); the engine is
asked instead (`_needed`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _weight_grad(g_out, x, weight, stride, padding, transposed):
    """d loss / d weight of a convolution (transposed or not) from its
    output gradient: cuDNN's weight-gradient kernel."""
    return torch.ops.aten.convolution_backward(
        g_out, x, weight, None, [stride] * 2, [padding] * 2, [1, 1], transposed, [0, 0], 1,
        [False, True, False])[1]


def _needed(ctx, i: int) -> bool:
    """Whether the backward pass now running uses the gradient of input i.
    The engine answers for a non-leaf input's node; the wrappers below
    hand no leaf that requires grad to the Functions."""
    return ctx.needs_input_grad[i] and torch._C._will_engine_execute_node(
        ctx.next_functions[i][0])


def _non_leaf(t: torch.Tensor) -> torch.Tensor:
    """t, or a view of it when it is a leaf that requires grad (the engine
    cannot say whether a leaf's node runs under autograd.grad)."""
    return t.view_as(t) if t.requires_grad and t.is_leaf else t


class _Conv2d(torch.autograd.Function):
    """F.conv2d whose backward is made of convolutions (module docstring)."""

    @staticmethod
    def forward(ctx, x, weight, stride, padding):
        ctx.save_for_backward(x, weight)
        ctx.conf = (stride, padding)
        return F.conv2d(x, weight, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, g_out):
        x, weight = ctx.saved_tensors
        stride, padding = ctx.conf
        gx = gw = None
        if _needed(ctx, 0):
            size = [(g_out.shape[d] - 1) * stride - 2 * padding + weight.shape[d]
                    for d in (2, 3)]
            gx = F.conv_transpose2d(
                g_out, weight, stride=stride, padding=padding,
                output_padding=[x.shape[d] - size[d - 2] for d in (2, 3)])
        if _needed(ctx, 1):
            gw = _weight_grad(g_out, x, weight, stride, padding, False)
        return gx, gw, None, None


class _ConvTranspose2d(torch.autograd.Function):
    """F.conv_transpose2d with a backward of convolutions (see _Conv2d)."""

    @staticmethod
    def forward(ctx, x, weight, stride, padding):
        ctx.save_for_backward(x, weight)
        ctx.conf = (stride, padding)
        return F.conv_transpose2d(x, weight, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, g_out):
        x, weight = ctx.saved_tensors
        stride, padding = ctx.conf
        gx = gw = None
        if _needed(ctx, 0):
            gx = F.conv2d(g_out, weight, stride=stride, padding=padding)
        if _needed(ctx, 1):
            gw = _weight_grad(g_out, x, weight, stride, padding, True)
        return gx, gw, None, None


def conv2d(x, weight_oihw, stride=1, padding=0):
    """F.conv2d(x, weight, stride=stride, padding=padding)."""
    return _Conv2d.apply(_non_leaf(x), _non_leaf(weight_oihw), stride, padding)


def conv_transpose2d(x, weight_iohw, stride=1, padding=0):
    """F.conv_transpose2d(x, weight, stride=stride, padding=padding)."""
    return _ConvTranspose2d.apply(_non_leaf(x), _non_leaf(weight_iohw), stride, padding)
