"""ResNet-20 / CIFAR-10 trained as a population on the card.

The counterpart of :mod:`hyperopt_tpu.models.resnet` (BASELINE.json
config #4, the lr + weight-decay sweep): ``ResNet``/``resnet20`` are
``nn.Module``s with the reference's flax layers -- 3x3 convolutions
without bias, ``GroupNorm(8, eps=1e-6)`` (no batch statistics, so the
members stay independent), the 1x1 projection shortcut where a block
changes shape, global average pooling and a dense head -- and a
population of their parameters trains in one step: ``torch.func.vmap``
over the members of ``torch.func.grad_and_value`` over
``torch.func.functional_call``.  Under ``vmap`` a convolution with
per-member weights runs as one grouped convolution.

The public input stays NHWC ``[B, H, W, 3]`` as in the reference; inside,
``permute(0, 3, 1, 2)`` gives NCHW, copied to contiguous memory (under
``vmap``, GroupNorm refuses channels-last tensors).  Flax's
``SAME`` padding is asymmetric at stride 2 on an even input ((0, 1) on
each spatial axis), so every convolution pads explicitly with flax's
split before a ``padding=0`` convolution.  The population step runs
under cuDNN's deterministic algorithms
(:func:`~hyperopt_tpu_torch.models._population.deterministic_kernels`),
so a captured step is bitwise its eager step.

``init_population`` draws flax's distributions from the port's
threefry, not flax's bits: parity with the reference holds on weights
carried over by :func:`hyperopt_tpu_torch.convert.resnet_params_from_numpy`.
Entry points compute on the card unless the caller passes
``device="cpu"``.  ``mesh=`` places the population step as the
reference's sharding constraints place it
(:func:`~hyperopt_tpu_torch.models._population.on_mesh`): bitwise the
step without a mesh.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import random as R
from ..utils import resolve_device
from ._population import (apply, deterministic_kernels, init_members, member_train_step,
                          on_mesh, zeros_like)

__all__ = [
    "ResNet",
    "hpo_space",
    "init_population",
    "make_population_train_step",
    "population_objective",
    "resnet20",
    "synthetic_cifar_batch",
]


def _same_conv(x, conv):
    """``conv`` (built with ``padding=0``) over flax's ``SAME`` padding:
    ``max((ceil(n / s) - 1) s + k - n, 0)`` per spatial axis, the smaller
    half before."""
    pads = []
    for n, k, s in zip(reversed(x.shape[-2:]), reversed(conv.kernel_size),
                       reversed(conv.stride)):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    if any(pads):
        x = F.pad(x, pads)
    return conv(x)


def _conv(c_in, c_out, k, stride=1):
    return nn.Conv2d(c_in, c_out, k, stride=stride, padding=0, bias=False)


class _BasicBlock(nn.Module):
    def __init__(self, c_in, filters, stride):
        super().__init__()
        self.conv1 = _conv(c_in, filters, 3, stride)
        self.norm1 = nn.GroupNorm(8, filters, eps=1e-6)
        self.conv2 = _conv(filters, filters, 3)
        self.norm2 = nn.GroupNorm(8, filters, eps=1e-6)
        # the reference projects where the residual's shape differs
        self.project = stride != 1 or c_in != filters
        if self.project:
            self.shortcut = _conv(c_in, filters, 1, stride)
            self.shortcut_norm = nn.GroupNorm(8, filters, eps=1e-6)

    def forward(self, x):
        y = F.relu(self.norm1(_same_conv(x, self.conv1)))
        y = self.norm2(_same_conv(y, self.conv2))
        if self.project:
            x = self.shortcut_norm(_same_conv(x, self.shortcut))
        return F.relu(y + x)


class ResNet(nn.Module):
    """CIFAR ResNet: a 3x3 stem, ``stage_sizes`` basic blocks per stage at
    ``width * 2**stage`` channels (stride 2 at each later stage's first
    block), global average pooling and a dense head.  ``images [B, H, W,
    3]`` -> ``logits [B, num_classes]``."""

    def __init__(self, stage_sizes=(3, 3, 3), num_classes=10, width=16):
        super().__init__()
        self.stem = _conv(3, width, 3)
        self.stem_norm = nn.GroupNorm(8, width, eps=1e-6)
        blocks, c = [], width
        for stage, n_blocks in enumerate(stage_sizes):
            filters = width * 2**stage
            for block in range(n_blocks):
                blocks.append(_BasicBlock(c, filters, 2 if stage > 0 and block == 0 else 1))
                c = filters
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(c, num_classes)

    def features(self, images):
        """The activations after the stem and after each block, NCHW."""
        x = images.permute(0, 3, 1, 2).contiguous()
        y = F.relu(self.stem_norm(_same_conv(x, self.stem)))
        out = [y]
        for block in self.blocks:
            y = block(y)
            out.append(y)
        return out

    def forward(self, images):
        return self.head(self.features(images)[-1].mean(dim=(2, 3)))


def resnet20(num_classes=10, width=16):
    """Standard CIFAR ResNet-20: 3 stages x 3 basic blocks, 16/32/64 ch."""
    return ResNet(stage_sizes=(3, 3, 3), num_classes=num_classes, width=width)


def _class_means(num_classes, device):
    """``jnp.linspace(-1.0, 1.0, num_classes)`` in float32, as XLA
    compiles it: ``t = i * r`` with ``r = 1/div`` rounded, then ``i * r -
    (1 - t)`` as one multiply-add, for ``i < div``; then the stop."""
    div = num_classes - 1
    r = float(np.float32(1.0) / np.float32(div))
    i = torch.arange(div, dtype=torch.float32, device=device)
    out = R._fma(i, r, -(1.0 - i * r))
    return torch.cat([out, torch.ones(1, device=device)])


def synthetic_cifar_batch(key, batch_size=128, image_size=32, num_classes=10):
    """A CIFAR-shaped synthetic batch on ``key``'s device: labels (int64
    ``[B]``) and images (``[B, H, W, 3]``) around class-conditional means,
    so the task is learnable.  The labels are the reference's bits, the
    images within the port's normal draws' 2 ulp of them."""
    k_lbl, k_img = R.split(key).unbind(-2)
    labels = R.randint(k_lbl, (batch_size,), 0, num_classes)
    means = _class_means(num_classes, key.device)[labels]
    images = means[:, None, None, None] * 0.5 + 0.5 * R.normal(
        k_img, (batch_size, image_size, image_size, 3))
    return images, labels


def make_population_train_step(model, mesh=None, trial_axis="trial", data_axis="cand",
                               device=None):
    """``train_step(pop_params, pop_momentum, lr [P], wd [P], images,
    labels) -> (params, momentum, losses [P])``: one SGD(+momentum,
    +weight decay) cross-entropy step of every member on the shared
    batch, the losses taken before it, under cuDNN's deterministic
    algorithms.  The tensors live on ``device`` (None = the card).
    ``mesh`` places the population on ``trial_axis`` and the images and
    labels on ``data_axis``, as the reference's sharding constraints do
    (:func:`~hyperopt_tpu_torch.models._population.on_mesh`): the same
    step, bit for bit."""
    resolve_device(device)

    def loss_fn(params, images, labels):
        logits = apply(model, params, images)
        return F.cross_entropy(logits, labels)

    pop_step = torch.func.vmap(
        lambda p, m, lr, wd, images, labels: member_train_step(loss_fn, p, m, lr, wd, images,
                                                               labels),
        in_dims=(0, 0, 0, 0, None, None),
    )

    def train_step(pop_params, pop_momentum, lr, wd, images, labels):
        with deterministic_kernels():
            return pop_step(pop_params, pop_momentum, lr, wd, images, labels)

    return on_mesh(train_step, mesh, trial_axis, data_axis, "make_population_train_step")


def init_population(model, pop_size, key, image_size=32, device=None):
    """``pop_size`` members of ``model``'s parameters, ``{name: [P,
    ...]}`` on ``device`` (None = the card), member ``i`` drawn from
    ``split(key, P)[i]`` (``image_size`` is the reference's dummy input
    size; the shapes here come from the module)."""
    del image_size
    return init_members(model, pop_size, key, device)


def hpo_space():
    """The lr+wd sweep space (config #4)."""
    from .. import hp

    return {
        "lr": hp.loguniform("lr", np.log(1e-4), np.log(1.0)),
        "wd": hp.loguniform("wd", np.log(1e-6), np.log(1e-2)),
    }


def population_objective(pop_size=4, n_steps=3, batch_size=32, image_size=8, width=8, seed=0,
                         mesh=None, device=None):
    """An ``fmin`` objective: train one member (the tiny 1-1-1 net at
    ``width <= 8``, else ``resnet20()``) with the suggested lr/wd for
    ``n_steps`` population steps on ``device`` (None = the card) from
    the same initial point each call, and return the last step's
    training loss (``pop_size`` is unused, as in the reference)."""
    dev = resolve_device(device)
    model = ResNet(stage_sizes=(1, 1, 1), width=width) if width <= 8 else resnet20()
    step = make_population_train_step(model, mesh=mesh, device=dev)
    init_key, data_key = R.split(R.key(seed, device=dev)).unbind(0)
    images, labels = synthetic_cifar_batch(data_key, batch_size, image_size)

    def objective(cfg):
        params = init_population(model, 1, init_key, image_size, device=dev)
        momentum = zeros_like(params)
        lr = torch.tensor([cfg["lr"]], dtype=torch.float32, device=dev)
        wd = torch.tensor([cfg["wd"]], dtype=torch.float32, device=dev)
        loss = None
        for _ in range(n_steps):
            params, momentum, loss = step(params, momentum, lr, wd, images, labels)
        return float(loss[0])

    return objective
