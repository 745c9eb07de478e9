"""DeepLDDMMAtlas: a CNN predicts each subject's initial momenta; the
gradients flow from the image match through the differentiable shooting
into the network's parameters and the atlas image.

Port of ``lagomorph_tpu/models/deep_atlas.py`` (flax and optax) to
``torch.nn`` and ``torch.optim``.  The network's convolutions are
PyTorch's (cuDNN on the card), as the JAX network's are XLA's: no Pallas
kernel lies there.  The shooting runs the port's kernels.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..deform import interp
from ..lddmm import _host, _torch_dtype, expmap
from ..metric import FluidMetric
from ..parallel import pad_batch_to_multiple, shard_batch
from ..utils import progress, torch_device

__all__ = ["MomentumNet", "DeepLDDMMAtlas", "init_momentum_net", "pad_batch_to_multiple"]

# standard deviation of the standard normal truncated to [-2, 2], by which
# flax's lecun_normal divides its scale
_TRUNC_STD = 0.87962566103423978


@contextlib.contextmanager
def _full_float32():
    """cuDNN's convolutions in full float32 for the block, its TF32 setting
    restored after (on the card they run in TF32 by default, which rounds
    the inputs to 10 bits of mantissa)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class MomentumNet(nn.Module):
    """Small convolutional net predicting a momentum field ``(N, dim,
    *spatial)`` from an image ``(N, in_channels, *spatial)``: four
    ``Conv{dim}d`` of kernel 3, zero padding 1 and a bias (``features``,
    ``features``, ``features``, ``dim`` outputs), tanh-approximated GELU
    between them (flax's ``nn.gelu``), the output times ``scale`` (a small
    scale keeps the first deformations in the unit regime)."""

    def __init__(self, dim=2, features=16, scale=1e-3, in_channels=1):
        super().__init__()
        if dim not in (2, 3):
            raise ValueError(f"MomentumNet is 2D or 3D, not {dim}D")
        self.dim = dim
        self.scale = scale
        conv = nn.Conv2d if dim == 2 else nn.Conv3d
        widths = (in_channels, features, features, features, dim)
        self.convs = nn.ModuleList(conv(a, b, 3, padding=1) for a, b in zip(widths, widths[1:]))

    def forward(self, img):
        x = img
        with _full_float32():
            for i, c in enumerate(self.convs):
                x = c(x)
                if i < len(self.convs) - 1:
                    x = F.gelu(x, approximate="tanh")
        return self.scale * x


def init_momentum_net(net, seed=0):
    """Draw ``net``'s convolution weights as flax's ``lecun_normal`` draws
    them (a standard normal truncated at ±2, scaled to variance 1/fan_in),
    from a ``torch.Generator`` seeded by ``seed``, on the host, and zero its
    biases.  The draws are not flax's: ``convert.momentum_net_state``
    carries a flax net's parameters across."""
    gen = torch.Generator().manual_seed(int(seed))
    lo = math.erf(-2.0 / math.sqrt(2.0))  # 2 * Phi(-2) - 1
    with torch.no_grad():
        for c in net.convs:
            w = c.weight
            u = torch.rand(w.shape, generator=gen, dtype=torch.float64) * (-2.0 * lo) + lo
            std = math.sqrt(1.0 / (w[0].numel())) / _TRUNC_STD
            w.copy_(math.sqrt(2.0) * torch.erfinv(u) * std)
            c.bias.zero_()
    return net


class DeepLDDMMAtlas:
    """Train a momentum-prediction network and an atlas image jointly:

    ``loss = MSE(I o phi^{-1}(f_theta(img)), img) / |Omega| + reg_weight *
    <v, m> / |Omega|``, over the subjects a 0/1 mask keeps.

    The JAX constructor and methods on one device: the minibatches are host
    numpy arrays, staged on ``device`` (the first CUDA card when None; pass
    ``"cpu"`` for the plain versions) each step; the network (``net``, a
    :class:`MomentumNet` of the data's dimension by default) is initialised
    by :func:`init_momentum_net` from ``seed``, in ``dtype``, and trained
    by ``torch.optim.Adam`` (optax's ``adam``); the atlas by ``I <- I -
    learning_rate_image * g_I / sum(mask)``.

    ``mesh`` (a :class:`..parallel.mesh.Mesh`; ``device`` is then its first
    entry): each minibatch is padded to a multiple of the mesh size (the
    padded subjects masked out) and split over it; the network's parameters
    and the atlas are copied to each entry (``.to``, so that one device may
    appear more than once), each entry's masked sums are added on the first,
    and autograd sums the gradients of the copies for one Adam step."""

    def __init__(self, dataset, metric=None, net=None, batch_size=8, integration_steps=5,
                 reg_weight=1e-1, learning_rate_net=1e-4, learning_rate_image=1e3, mesh=None,
                 seed=0, dtype=np.float32, progress_bar=True, device=None):
        from ..data import batch_average, batch_iterator

        self.device = torch_device(device) if mesh is None else mesh.devices[0]
        self.dtype = _torch_dtype(dtype)
        self.metric = metric or FluidMetric([0.1, 0.0, 0.01])
        self.batches = list(batch_iterator(dataset, batch_size, dtype=dtype))
        self.n_examples = sum(b.shape[0] for b in self.batches)
        self.integration_steps = integration_steps
        self.reg_weight = reg_weight
        self.progress_bar = progress_bar
        self.mesh = mesh

        I0 = batch_average(self.batches, progress_bar=False).squeeze()
        self.dim = I0.ndim
        self.I = torch.as_tensor(I0[None, None], dtype=self.dtype, device=self.device)
        self.net = net or MomentumNet(dim=self.dim, in_channels=self.batches[0].shape[1])
        init_momentum_net(self.net, seed)
        self.net.to(device=self.device, dtype=self.dtype)
        self.opt = torch.optim.Adam(self.net.parameters(), lr=learning_rate_net,
                                    betas=(0.9, 0.999), eps=1e-8)
        self.lr_I = learning_rate_image
        self.epoch_losses = []
        self._pad_multiple = 1 if mesh is None else mesh.size

    def _put(self, x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=self.dtype, device=self.device)

    def _sums(self, I, img, mask, params=None):
        """The masked sums of the squared image error and of ``<v, m>`` over
        ``img``'s subjects; ``params``: the network's parameters to run it
        with (copies on ``img``'s device), its own when None."""
        if params is None:
            m = self.net(img)
        else:
            m = torch.func.functional_call(self.net, params, (img,))
        v = self.metric.sharp(m)  # shared with the peeled first step
        h = expmap(self.metric, m, num_steps=self.integration_steps, v0=v)
        Idef = interp(I, h)
        sq = torch.sum((Idef - img) ** 2, dim=tuple(range(1, img.dim())))
        vm = torch.sum(v * m, dim=tuple(range(1, m.dim())))
        return torch.sum(sq * mask), torch.sum(vm * mask)

    def _loss(self, I, img, mask):
        numel = torch.sum(mask) * float(np.prod(img.shape[1:]))
        if self.mesh is None:
            sq, vm = self._sums(I, img, mask)
        else:
            named = dict(self.net.named_parameters())
            sq = vm = None
            for ik, mk in zip(shard_batch(img, self.mesh), shard_batch(mask, self.mesh)):
                dev = ik.device
                s, w = self._sums(I.to(dev), ik, mk, {k: p.to(dev) for k, p in named.items()})
                sq = s.to(I.device) if sq is None else sq + s.to(I.device)
                vm = w.to(I.device) if vm is None else vm + w.to(I.device)
        return sq / numel + self.reg_weight * vm / numel

    def _train_step(self, img, mask):
        """One Adam step of the network and one descent step of the atlas
        on the minibatch ``img`` (``mask``: 0/1 per subject).  Returns the
        loss before the step, on the device."""
        params = list(self.net.parameters())
        with _full_float32(), torch.enable_grad():
            I = self.I.detach().requires_grad_(True)
            loss = self._loss(I, img, mask)
            *gp, gI = torch.autograd.grad(loss, params + [I])
        for p, g in zip(params, gp):
            p.grad = g
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        with torch.no_grad():
            self.I = self.I - self.lr_I * gI / torch.sum(mask)
        return loss.detach()

    def fit(self, num_epochs=10):
        epbar = range(num_epochs)
        if self.progress_bar:
            epbar = progress(epbar, desc="epoch")
        for _ in epbar:
            total = 0.0
            for b in self.batches:
                n_real = b.shape[0]
                b_pad, _ = pad_batch_to_multiple(np.asarray(b), self._pad_multiple)
                mask = np.zeros(b_pad.shape[0], dtype=b_pad.dtype)
                mask[:n_real] = 1.0
                loss = self._train_step(self._put(b_pad), self._put(mask))
                total += float(loss) * (n_real / self.n_examples)
            self.epoch_losses.append(total)
            if hasattr(epbar, "set_postfix"):
                epbar.set_postfix(loss=total)
        return self

    def predict_momenta(self, img):
        with torch.no_grad():
            return self.net(self._put(_host(img)))

    def deform_atlas(self, img):
        m = self.predict_momenta(img)
        with torch.no_grad():
            h = expmap(self.metric, m, num_steps=self.integration_steps)
            return interp(self.I, h)
