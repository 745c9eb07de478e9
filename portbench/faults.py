"""Faults planted in the program under test, and the program's own
lower-precision path, for the control (``control.py``) and the tests: a run
with any of them has to come out not correct.  Each is made before the
builder is built and applied to the built builder; ``undo`` restores the
port's package."""
from __future__ import annotations

import torch


class Fault:
    image_dtype = None

    def apply(self, builder):
        pass

    def undo(self):
        pass


class Bfloat16Images(Fault):
    """The control: the builder's own ``image_dtype="bfloat16"`` path, the
    images kept on the device in bfloat16 (the step computes in float32)."""
    image_dtype = "bfloat16"


class Unchanged(Fault):
    """A step that returns its state unchanged: the momenta as they came
    in, no atlas gradient."""

    def apply(self, builder):
        step = builder._step

        def unchanged(I, m, img, mask=None, count=None):
            _, gI, loss, reg = step(I, m, img, mask, count)
            return m, torch.zeros_like(gI), loss, reg

        builder._step = unchanged


class HalfBatch(Fault):
    """Half of each minibatch left out, the mean taken over the rest; the
    left-out subjects' momenta come back unchanged."""

    def apply(self, builder):
        step = builder._step

        def half(I, m, img, mask=None, count=None):
            h = m.shape[0] // 2
            mask_h = None if mask is None else mask[:h]
            count_h = None if count is None else count // 2
            m_h, gI, loss, reg = step(I, m[:h], img[:h], mask_h, count_h)
            return torch.cat([m_h, m[h:]]), gI, loss, reg

        builder._step = half


class NoExchange(Fault):
    """The exchange between processes left out: ``allsum_`` does nothing,
    so each process keeps its own loss and atlas gradient."""

    def __init__(self):
        from lagomorph_tpu_torch.parallel import distributed

        self.mod, self.orig = distributed, distributed.allsum_
        distributed.allsum_ = lambda *tensors: tensors

    def undo(self):
        self.mod.allsum_ = self.orig


FAULTS = {"bf16_images": Bfloat16Images, "unchanged": Unchanged, "half_batch": HalfBatch,
          "no_exchange": NoExchange}
