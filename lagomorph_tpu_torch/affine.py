"""Affine registration and atlas building.

Port of ``lagomorph_tpu/affine.py``: the batched small-matrix and rigid
helpers (closed-form 2x2 and 3x3 inverses, ``affine_inverse``,
``rotation_exp_map``, ``rigid_inverse``), the per-minibatch affine atlas
update (``make_affine_atlas_step``: the affine warp, the mean squared
error and ridge terms, their gradients by autograd, SGD on the transforms),
the epoch loop of :func:`affine_atlas` on one device or a device mesh,
:class:`StandardizedDataset` and the ``affine atlas`` / ``affine
standardize`` commands.  The warp is plain PyTorch on the general gather
(:func:`.ops.affine.affine_interp`), as in the JAX package, where it reaches
no Pallas kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.affine import affine_interp, regrid  # noqa: F401  (regrid re-exported)
from .utils import Tool, progress, torch_device

__all__ = [
    "affine_interp",
    "regrid",
    "det_2x2",
    "invert_2x2",
    "minor",
    "invert_3x3",
    "affine_inverse",
    "rotation_exp_map",
    "rigid_inverse",
    "make_affine_atlas_step",
    "affine_atlas",
    "StandardizedDataset",
]


# --- batched small-matrix helpers: closed forms (adjugate and cofactors),
# which round as the JAX package's do -------------------------------------

def det_2x2(A):
    return A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]


def invert_2x2(A):
    """Invert a batch of 2x2 matrices by the adjugate."""
    det = det_2x2(A)
    adj = torch.stack([A[:, 1, 1], -A[:, 0, 1], -A[:, 1, 0], A[:, 0, 0]], dim=1)
    return adj.reshape(-1, 2, 2) / det.reshape(-1, 1, 1)


def minor(A, i, j):
    """The batch of matrices ``A`` without row ``i`` and column ``j``."""
    n = A.shape[1]
    if A.shape[2] != n:
        raise ValueError(f"minor of non-square matrices {tuple(A.shape)}")
    rows = [r for r in range(n) if r != i]
    cols = [c for c in range(n) if c != j]
    return A[:, rows][:, :, cols]


def invert_3x3(A):
    """Invert a batch of 3x3 matrices by cofactors."""
    cof = torch.stack(
        [(-1) ** (i + j) * det_2x2(minor(A, i, j)) for i in range(3) for j in range(3)], dim=1
    ).reshape(-1, 3, 3).transpose(1, 2)
    det = cof[:, 0, 0] * A[:, 0, 0] + cof[:, 1, 0] * A[:, 0, 1] + cof[:, 2, 0] * A[:, 0, 2]
    return cof / det.reshape(-1, 1, 1)


def affine_inverse(A, T):
    """Invert affine transformations: ``(A, T)^{-1} = (A^{-1}, -A^{-1} T)``
    for ``A`` ``(N, dim, dim)`` and ``T`` ``(N, dim)``, ``dim`` 2 or 3."""
    dim = A.shape[1]
    if A.shape[2] != dim or T.shape[1] != dim or dim not in (2, 3):
        raise ValueError(f"affine_inverse of A {tuple(A.shape)}, T {tuple(T.shape)}")
    Ainv = invert_2x2(A) if dim == 2 else invert_3x3(A)
    Tinv = -torch.einsum("nab,nb->na", Ainv, T)
    return Ainv, Tinv


def rotation_exp_map(v):
    """Rotation matrices from rotation tangent vectors: 2D from a vector of
    angles ``(N,)``, 3D from axis-angle vectors ``(N, 3)``."""
    v = torch.as_tensor(v)
    if v.dim() == 1:
        c = torch.cos(v).reshape(-1, 1)
        s = torch.sin(v).reshape(-1, 1)
        return torch.stack([c, -s, s, c], dim=1).reshape(-1, 2, 2)
    if v.dim() == 2 and v.shape[1] == 3:
        # Rodrigues on the unnormalised vector, R = I + a [v]_x + b [v]_x^2
        # with a = sin t / t and b = (1 - cos t) / t^2, both analytic in t^2:
        # below the threshold their Taylor series keep the value and the
        # gradient exact at v = 0, and t2s keeps the untaken branch finite
        # there (a NaN in it would reach the gradient through where)
        theta2 = torch.sum(v * v, dim=1)[:, None, None]
        small = theta2 < 1e-8
        t2s = torch.where(small, torch.ones_like(theta2), theta2)
        theta = torch.sqrt(t2s)
        a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
        b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / t2s)
        vx, vy, vz = v[:, 0], v[:, 1], v[:, 2]
        zeros = torch.zeros_like(vx)
        K = torch.stack([zeros, -vz, vy, vz, zeros, -vx, -vy, vx, zeros], dim=1).reshape(-1, 3, 3)
        eye = torch.eye(3, dtype=v.dtype, device=v.device)[None]
        return eye + a * K + b * torch.einsum("nab,nbc->nac", K, K)
    raise ValueError(f"Cannot infer dimension from v shape {tuple(v.shape)}")


def rigid_inverse(v, T):
    """Invert rigid transformations: ``(R(v), T)^{-1} = (R(-v), -R(-v) T)``;
    returns ``(-v, Tinv)``."""
    negv = -torch.as_tensor(v)
    Rinv = rotation_exp_map(negv)
    Tinv = -torch.einsum("nab,nb->na", Rinv, T)
    return negv, Tinv


# --- atlas building --------------------------------------------------------

def make_affine_atlas_step(spatial_dim, affine_steps=1, reg_weightA=0.0, reg_weightT=0.0,
                           learning_rate_A=1e-3, learning_rate_T=1e-2, mesh=None):
    """The per-minibatch affine atlas update.

    Returns ``step(I, A, T, img, mask=None) -> (A, T, I_grad, loss)``:
    ``affine_steps`` SGD steps on ``(A, T)`` (``A`` the offset from the
    identity) of the loss at ``A + eye``, the per-subject squared error over
    the atlas's spatial size plus the ridge terms ``0.5 w |A|^2`` and ``0.5
    w |T|^2`` where their weights are > 0, averaged over the subjects
    (``mask``: over the subjects it weights).  The atlas gradient and the
    loss are those of the last step.

    ``mesh`` (a :class:`.parallel.mesh.Mesh`): the subjects are split over
    its entries (``img`` may come split, a :class:`.parallel.mesh.Sharded`;
    ``A``, ``T``, ``mask`` and ``I`` are tensors on the first entry, the
    atlas copied to the others), each entry's masked sum is added on the
    first and divided by ``sum(mask)``; the JAX package's step jitted with
    the batch sharded over the mesh."""
    def per_subject(A, T, I, img):
        eye = torch.eye(spatial_dim, dtype=A.dtype, device=A.device)
        Idef = affine_interp(I, A + eye, T)
        numel = 1.0
        for s in I.shape[2:]:
            numel *= s
        sq = torch.sum((Idef - img) ** 2, dim=tuple(range(1, img.dim()))) / numel
        per = sq
        if reg_weightA > 0:
            per = per + 0.5 * reg_weightA * torch.sum(A * A, dim=(1, 2))
        if reg_weightT > 0:
            per = per + 0.5 * reg_weightT * torch.sum(T * T, dim=1)
        return per

    def loss_fn(A, T, I, img, mask):
        if mesh is not None:
            from .parallel.mesh import as_shards

            if mask is None:
                mask = torch.ones(A.shape[0], dtype=A.dtype, device=A.device)
            parts = (as_shards(x, mesh, 0) for x in (A, T, img, mask))
            total = None
            for Ak, Tk, ik, mk in zip(*parts):
                part = torch.sum(per_subject(Ak, Tk, I.to(Ak.device), ik) * mk).to(A.device)
                total = part if total is None else total + part
            return total / torch.sum(mask)
        per = per_subject(A, T, I, img)
        if mask is None:
            return torch.sum(per) / img.shape[0]
        return torch.sum(per * mask) / torch.sum(mask)

    def step(I, A, T, img, mask=None):
        loss = gI = None
        for it in range(affine_steps):
            last = it == affine_steps - 1
            leaves = [A.detach().requires_grad_(True), T.detach().requires_grad_(True)]
            if last:
                leaves.append(I.detach().requires_grad_(True))
            with torch.enable_grad():
                loss = loss_fn(leaves[0], leaves[1], leaves[2] if last else I, img, mask)
                grads = torch.autograd.grad(loss, leaves)
            A = A.detach() - learning_rate_A * grads[0]
            T = T.detach() - learning_rate_T * grads[1]
            if last:
                gI = grads[2]
        return A, T, gI, loss.detach()

    return step


def _put(x, device):
    """A numpy array as a tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def affine_atlas(dataset, As, Ts, I=None, num_epochs=1000, batch_size=50, image_update_freq=0,
                 affine_steps=1, reg_weightA=0e1, reg_weightT=0e1, learning_rate_A=1e-3,
                 learning_rate_T=1e-2, learning_rate_I=1e5, mesh=None, progress_bar=True,
                 keep_data_on_device=False, loader_workers=None, gpu=None, world_size=None,
                 rank=None, device=None):
    """Affine atlas building on one device.

    ``dataset`` yields images ``(C, *spatial)`` or ``(index, image)``
    pairs; ``As`` ``(n, dim, dim)`` (offsets from the identity) and ``Ts``
    ``(n, dim)`` are numpy arrays of per-subject transforms, updated in
    place and returned; ``I``: the initial atlas (the mean image when
    None).  Each epoch runs :func:`make_affine_atlas_step` on every
    minibatch in order and updates the atlas by its mean gradient every
    ``image_update_freq`` iterations (0: once an epoch).  The images and
    transforms stream from the host a minibatch at a time
    (``keep_data_on_device``: the images are staged once and each
    minibatch's transforms stay on the device, written back at the end).
    ``device``: a torch device, the first CUDA card when None (no fallback
    to the CPU).  ``mesh`` (a :class:`.parallel.mesh.Mesh`; ``device`` is
    then its first entry): each minibatch is padded to a multiple of the
    mesh size (the padded subjects masked out) and split over it
    (:func:`make_affine_atlas_step` with ``mesh``).  ``loader_workers``,
    ``gpu``, ``world_size`` and ``rank`` are accepted and unused, as in the
    JAX package.

    Returns ``(I, As, Ts, epoch_losses, iter_losses)``, ``I`` a tensor
    ``(1, 1, *spatial)`` on the device."""
    from .data import IndexedDataset, batch_average, batch_iterator
    from .parallel import pad_batch_to_multiple, shard_batch

    device = torch_device(device) if mesh is None else mesh.devices[0]
    As = np.asarray(As)
    Ts = np.asarray(Ts)
    probe = dataset[0]
    if not (isinstance(probe, tuple) and len(probe) == 2 and np.isscalar(probe[0])):
        dataset = IndexedDataset(dataset)

    batches = list(batch_iterator(dataset, batch_size, dtype=As.dtype))
    n_total = sum(b[1].shape[0] for b in batches)
    if I is None:
        I = batch_average(batches, progress_bar=progress_bar)
    elif isinstance(I, torch.Tensor):
        I = I.detach().cpu().numpy()
    I = np.asarray(I, dtype=As.dtype).squeeze()
    I = _put(I[None, None], device)

    step = make_affine_atlas_step(I.dim() - 2, affine_steps=affine_steps, reg_weightA=reg_weightA,
                                  reg_weightT=reg_weightT, learning_rate_A=learning_rate_A,
                                  learning_rate_T=learning_rate_T, mesh=mesh)
    pad_multiple = 1 if mesh is None else mesh.size

    def put_img(img):
        return _put(img, device) if mesh is None else shard_batch(img, mesh)

    def image_update(I, g, n):
        return I - learning_rate_I * (g / float(n))

    # each minibatch padded to the mesh, with its mask
    staged = []
    for ix, img in batches:
        n_real = img.shape[0]
        img, _ = pad_batch_to_multiple(img, pad_multiple)
        mask = np.zeros(img.shape[0], dtype=img.dtype)
        mask[:n_real] = 1.0
        if keep_data_on_device:
            img, mask = put_img(img), _put(mask, device)
        staged.append((ix, img, mask, n_real))

    dev_AT = {}  # per-minibatch (A, T) on the device, with keep_data_on_device
    epoch_losses = []
    iter_losses = []
    epbar = range(num_epochs)
    if progress_bar:
        epbar = progress(epbar, desc="epoch")
    Igrad = torch.zeros_like(I)
    image_iters = 0
    for _ in epbar:
        epoch_loss = 0.0
        itbar = progress(staged, desc="iter", leave=False) if progress_bar else staged
        for bi, (ix, img, mask, n_real) in enumerate(itbar):
            if bi in dev_AT:
                A, T = dev_AT[bi]
            else:
                A = _put(pad_batch_to_multiple(As[ix], pad_multiple)[0], device)
                T = _put(pad_batch_to_multiple(Ts[ix], pad_multiple)[0], device)
            if not keep_data_on_device:
                img, mask = put_img(img), _put(mask, device)
            A, T, gI, loss = step(I, A, T, img, mask)
            if keep_data_on_device:
                dev_AT[bi] = (A, T)
            else:
                As[ix] = A.cpu().numpy()[:n_real]
                Ts[ix] = T.cpu().numpy()[:n_real]
            Igrad = Igrad + gI
            image_iters += 1
            li = float(loss) * (n_real / n_total)
            iter_losses.append(li)
            epoch_loss += li
            if image_update_freq > 0 and image_iters >= image_update_freq:
                I = image_update(I, Igrad, image_iters)
                Igrad = torch.zeros_like(I)
                image_iters = 0
        if image_iters > 0:
            I = image_update(I, Igrad, image_iters)
            Igrad = torch.zeros_like(I)
            image_iters = 0
        epoch_losses.append(epoch_loss)
        if hasattr(epbar, "set_postfix"):
            epbar.set_postfix(epoch_loss=epoch_loss)
    for bi, (A, T) in dev_AT.items():
        ix, _, _, n_real = staged[bi]
        As[ix] = A.cpu().numpy()[:n_real]
        Ts[ix] = T.cpu().numpy()[:n_real]
    return I, As, Ts, epoch_losses, iter_losses


class StandardizedDataset:
    """``dataset`` with each item mapped back through the inverse of its
    affine transform (``As`` offsets from the identity, ``Ts``), computed
    on ``device`` (the first CUDA card when None) when the item is read.
    Items come out as numpy arrays, float32 unless they are float
    already."""

    def __init__(self, dataset, As, Ts, device=None):
        self.dataset = dataset
        self.As = np.asarray(As)
        self.Ts = np.asarray(Ts)
        self.device = torch_device(device)
        self.eye = np.eye(self.Ts.shape[1], dtype=self.As.dtype)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        J = np.asarray(self.dataset[idx])
        if J.dtype not in (np.float32, np.float64):
            J = J.astype(np.float32)
        Ainv, Tinv = affine_inverse(_put(self.As[[idx]] + self.eye, self.device),
                                    _put(self.Ts[[idx]], self.device))
        return affine_interp(_put(J[None], self.device), Ainv, Tinv)[0].cpu().numpy()


class _Tool(Tool):
    """Affine registration methods"""

    module_name = "lagomorph_tpu_torch affine"
    subcommands = ["atlas", "standardize"]

    def atlas(self):
        """
        Build affine atlas from HDF5 image dataset.

        Writes an HDF5 file with datasets: atlas, A, T, epoch_losses,
        iter_losses; provenance attrs are stamped on 'atlas'.
        """
        import sys

        parser = self.new_parser("atlas")
        dg = parser.add_argument_group("data parameters")
        dg.add_argument("input", type=str, help="Path to input image HDF5 file")
        dg.add_argument("--force_dim", default=None, type=int,
                        help="Force dimension of images instead of determining based on "
                        "dataset shape")
        dg.add_argument("--h5key", "-k", default="images",
                        help="Name of dataset in input HDF5 file")
        dg.add_argument("--data_inmemory", action="store_true",
                        help="Load entire dataset into memory first")
        dg.add_argument("output", type=str, help="Path to output HDF5 file")
        ag = parser.add_argument_group("algorithm parameters")
        ag.add_argument("--num_epochs", default=1000, type=int, help="Number of epochs")
        ag.add_argument("--batch_size", default=50, type=int, help="Batch size")
        ag.add_argument("--image_update_freq", default=0, type=int,
                        help="Update base image every N iterations. 0 for once per epoch")
        ag.add_argument("--affine_steps", default=1, type=int,
                        help="Affine gradient steps to take each iteration")
        ag.add_argument("--reg_weight_A", default=1e-1, type=float)
        ag.add_argument("--reg_weight_T", default=1e-1, type=float)
        ag.add_argument("--learning_rate_A", default=1e-3, type=float)
        ag.add_argument("--learning_rate_T", default=1e-2, type=float)
        ag.add_argument("--learning_rate_I", default=1e4, type=float)
        ag.add_argument("--keep_data_on_device", action="store_true",
                        help="Stage all batches and transforms in device memory once")
        self._compute_args(parser)
        args = parser.parse_args(sys.argv[2:])
        self._initialize_compute(args)

        from .data import IndexedDataset, MemoryDataset, load_dataset

        dataset = load_dataset(args.input, key=args.h5key, force_dim=args.force_dim)
        if args.data_inmemory:
            dataset = MemoryDataset(dataset)
        dataset = IndexedDataset(dataset)

        n = len(dataset)
        dim = dataset[0][1].ndim - 1
        As = np.zeros((n, dim, dim), dtype=np.float32)
        Ts = np.zeros((n, dim), dtype=np.float32)

        I, As, Ts, epoch_losses, iter_losses = affine_atlas(
            dataset,
            As=As,
            Ts=Ts,
            num_epochs=args.num_epochs,
            batch_size=args.batch_size,
            affine_steps=args.affine_steps,
            image_update_freq=args.image_update_freq,
            reg_weightA=args.reg_weight_A,
            reg_weightT=args.reg_weight_T,
            learning_rate_A=args.learning_rate_A,
            learning_rate_T=args.learning_rate_T,
            learning_rate_I=args.learning_rate_I,
            keep_data_on_device=args.keep_data_on_device,
            mesh=self.mesh,
            progress_bar=self.rank == 0,
            device=self.device,
        )

        import h5py

        with h5py.File(args.output, "w") as f:
            atds = f.create_dataset("atlas", data=I.cpu().numpy())
            self._stamp_dataset(atds, args)
            f.create_dataset("A", data=np.asarray(As))
            f.create_dataset("T", data=np.asarray(Ts))
            f.create_dataset("epoch_losses", data=np.asarray(epoch_losses))
            f.create_dataset("iter_losses", data=np.asarray(iter_losses))

    def standardize(self):
        """
        Standardize a dataset using transforms found during atlas building.
        """
        import sys

        parser = self.new_parser("standardize")
        parser.add_argument("inputimages", type=str, help="Path to input image HDF5 file")
        parser.add_argument("atlasoutput", type=str,
                            help="Path to HDF5 output from affine atlas building")
        parser.add_argument("standardizedoutput", type=str, help="Path to output HDF5 file")
        parser.add_argument("--h5key", "-k", default="images",
                            help="Name of dataset in input and HDF5 files")
        parser.add_argument("--copy_other_keys", action="store_true",
                            help="Copy all other keys from input file into output verbatim")
        parser.add_argument("--rescale", default=None, type=float,
                            help="Amount by which to rescale translations. Default: automatic")
        self._compute_args(parser)
        args = parser.parse_args(sys.argv[2:])
        self._initialize_compute(args)

        import h5py

        from .data import H5Dataset, write_dataset_h5

        dataset = H5Dataset(args.inputimages, key=args.h5key)
        with h5py.File(args.atlasoutput, "r") as f:
            As = np.asarray(f["A"])
            Ts = np.asarray(f["T"])
            if args.rescale is None:
                # the translations in the images' voxels, from the ratio of
                # their shape to the atlas's
                d = Ts.shape[1]
                shnew = dataset[0].shape[-d:]
                shatlas = f["atlas"].shape[-d:]
                if tuple(shnew) != tuple(shatlas):
                    args.rescale = shnew[0] / shatlas[0]
                    for sn, sa in zip(shnew, shatlas):
                        if sn != args.rescale * sa:
                            raise Exception(
                                "Unclear how to rescale translations. You must pass the "
                                "--rescale argument directly."
                            )
                else:
                    args.rescale = 1.0
        Ts = Ts * args.rescale

        std_ds = StandardizedDataset(dataset, As, Ts, device=self.device)
        write_dataset_h5(std_ds, args.standardizedoutput, key=args.h5key)
        with h5py.File(args.standardizedoutput, "a") as fw:
            self._stamp_dataset(fw[args.h5key], args)
        if args.copy_other_keys:
            with h5py.File(args.inputimages, "r") as fi, \
                    h5py.File(args.standardizedoutput, "a") as fo:
                for k in progress(fi.keys(), desc="other keys"):
                    if k != args.h5key:
                        fi.copy(k, fo)
