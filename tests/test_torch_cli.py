"""The port's ``lddmm atlas``, ``affine atlas`` and ``affine standardize``
commands and their HDF5 files, on the CPU:

* a file saved by either package's builder loads in the other's and
  through ``convert.atlas_state_from_saved``, with the same keys and
  ``batch_sizes``;
* ``python -m lagomorph_tpu_torch lddmm atlas --device cpu`` against the
  JAX builder on the same file (float32: atlas and losses within 1e-5,
  momenta within 1e-4 of max|ref|, the two libraries' float32 FFTs
  rounding differently);
* in process: ``--checkpoint`` and a warm start from it through
  ``--initial_atlas``, ``--help`` (with the ``data`` verbs' flags), the
  process loader and the minibatch cache (equal to the default
  staging), ``--fluid_transform radix``,
  ``--warp_mode`` (``lddmm atlas --warp_mode general`` against the JAX
  command with the same flags; ``affine atlas`` / ``affine standardize
  --warp_mode unit``) and the options that are not ported, which raise;
* ``python -m lagomorph_tpu_torch affine atlas --device cpu`` and ``affine
  standardize`` against the JAX package's commands on the same file
  (float32: the atlas, the losses, ``A`` and ``T`` within 1e-5 of
  max|ref|), each package's ``standardize`` reading the other's atlas
  file.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lagomorph_tpu as lm
from lagomorph_tpu import data as jdata
from lagomorph_tpu.ops import set_warp_mode
import lagomorph_tpu_torch as lt
from lagomorph_tpu_torch import convert
from lagomorph_tpu_torch.__main__ import LagomorphTool
from lagomorph_tpu_torch.ops import fluid as tfluid

h5py = pytest.importorskip("h5py")
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"atlas", "momenta", "epoch_losses", "epoch_reg_terms", "iter_losses", "iter_reg_terms"}
TRAIN = ["--num_epochs", "2", "--batch_size", "4", "--lddmm_integration_steps", "3",
         "--fluid_alpha", "0.01", "--fluid_gamma", "0.1", "--learning_rate_m", "0.1",
         "--learning_rate_I", "100", "--reg_weight", "0.1"]


def blobs(path, n, res, dim, seed=5):
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.arange(res, dtype=float)] * dim, indexing="ij"))
    c = (res - 1) / 2
    imgs = [np.exp(-sum((grid[d] - c - o[d]) ** 2 for d in range(dim)) / (2 * (res / 5) ** 2))
            for o in rng.uniform(-1.5, 1.5, (n, dim))]
    with h5py.File(path, "w") as f:
        f.create_dataset("images", data=np.stack(imgs)[:, None].astype(np.float32))
    return str(path)


def run_module(module, argv):
    """``python -m module argv`` on the CPU, the repository on the path."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-m", module, *argv], capture_output=True, text=True,
                       cwd=REPO, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]


def run_tool(argv, monkeypatch):
    """The port's command line in this process (``python -m`` aside)."""
    monkeypatch.setattr(sys, "argv", ["lagomorph_tpu_torch", *argv])
    LagomorphTool().run()


def test_h5_files_load_in_either_builder(rng, tmp_path):
    """A builder's state saved by one package loads in the other (the
    atlas, each minibatch's momenta by ``batch_sizes``, the losses) and
    through ``convert.atlas_state_from_saved``."""
    imgs = list(rng.standard_normal((5, 1, 6, 5)).astype(np.float32))
    I0 = rng.standard_normal((6, 5)).astype(np.float32)
    ms = [rng.standard_normal((b, 2, 6, 5)).astype(np.float32) for b in (2, 2, 1)]
    kw = dict(num_epochs=1, batch_size=2, progress_bar=False)
    saved = {}
    for name, make in (("jax", lambda: lm.LDDMMAtlasBuilder(imgs, I0=I0, ms=ms, **kw)),
                       ("port", lambda: lt.LDDMMAtlasBuilder(imgs, I0=I0, ms=ms, device="cpu",
                                                             **kw))):
        b = make()
        b.initialize()
        b.epoch_losses.append(0.5)
        b.iter_losses.extend([0.25, 0.25])
        saved[name] = str(tmp_path / f"{name}.h5")
        b.save(saved[name])
    for src, make in (("jax", lambda: lt.LDDMMAtlasBuilder(imgs, device="cpu", **kw)),
                      ("port", lambda: lm.LDDMMAtlasBuilder(imgs, **kw))):
        with h5py.File(saved[src], "r") as f:
            assert set(f.keys()) == KEYS
            assert list(f["momenta"].attrs["batch_sizes"]) == [2, 2, 1]
            metric, I, m = convert.atlas_state_from_saved(f, (0.1, 0.0, 0.01), "cpu")
        np.testing.assert_array_equal(I.numpy(), I0[None, None])
        np.testing.assert_array_equal(m.numpy(), np.concatenate(ms))
        b = make()
        b.load(saved[src])
        b.initialize()
        np.testing.assert_array_equal(np.asarray(b.I)[0, 0], I0)
        for got, want in zip(b.ms, ms):
            np.testing.assert_array_equal(np.asarray(got), want)
        assert b.epoch_losses == [0.5] and b.iter_losses == [0.25, 0.25]


def test_cli_lddmm_atlas_matches_jax_builder(tmp_path):
    """``python -m lagomorph_tpu_torch lddmm atlas --device cpu`` writes
    what the JAX builder computes from the same file (an uneven last
    batch), with the provenance on ``atlas``."""
    src = blobs(tmp_path / "imgs.h5", 6, 12, 2)
    out = str(tmp_path / "atlas.h5")
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "lagomorph_tpu_torch", "lddmm", "atlas", src, out,
                        "--device", "cpu", *TRAIN], capture_output=True, text=True, cwd=REPO,
                       env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = lm.LDDMMAtlasBuilder(jdata.H5Dataset(src), num_epochs=2, batch_size=4,
                               lddmm_integration_steps=3, reg_weight=0.1,
                               learning_rate_pose=0.1, learning_rate_image=100.0,
                               metric=lm.FluidMetric([0.01, 0.0, 0.1]), progress_bar=False)
    prev = set_warp_mode("general")  # the same function, a third of the compile
    try:
        ref.run()
    finally:
        set_warp_mode(prev)
    with h5py.File(out, "r") as f:
        assert set(f.keys()) == KEYS
        assert f["atlas"].attrs["lagomorph_version"] == lt.__version__
        assert '"device": "cpu"' in f["atlas"].attrs["command_args"]
        assert list(f["momenta"].attrs["batch_sizes"]) == [4, 2]
        got = {k: f[k][...] for k in KEYS}
    for k, want, tol in (("atlas", ref.I, 1e-5), ("momenta", np.concatenate(ref.ms), 1e-4),
                         ("epoch_losses", ref.epoch_losses, 1e-5),
                         ("iter_losses", ref.iter_losses, 1e-5)):
        want = np.asarray(want)
        np.testing.assert_allclose(got[k], want, rtol=0, atol=tol * np.abs(want).max())
    assert got["epoch_losses"][-1] < got["epoch_losses"][0]


def test_cli_checkpoint_and_warm_start(tmp_path, monkeypatch):
    """``--checkpoint`` writes a file an epoch; ``--initial_atlas`` starts
    from it (its atlas, momenta and losses) and so matches a run of both
    epochs in one.  As in the JAX package, an epoch's checkpoint is written
    before its loss joins ``epoch_losses``."""
    src = blobs(tmp_path / "imgs.h5", 6, 12, 2)
    args = ["--device", "cpu", *TRAIN]
    run_tool(["lddmm", "atlas", src, str(tmp_path / "two.h5"), *args], monkeypatch)
    args[args.index("--num_epochs") + 1] = "1"
    run_tool(["lddmm", "atlas", src, str(tmp_path / "one.h5"), *args,
              "--checkpoint", str(tmp_path / "ck_{epoch}.h5")], monkeypatch)
    assert os.path.isfile(tmp_path / "ck_0.h5")
    run_tool(["lddmm", "atlas", src, str(tmp_path / "warm.h5"), *args,
              "--initial_atlas", str(tmp_path / "ck_0.h5")], monkeypatch)
    with h5py.File(tmp_path / "two.h5", "r") as a, h5py.File(tmp_path / "warm.h5", "r") as b:
        assert len(a["epoch_losses"]) == 2 and len(b["iter_losses"]) == 4
        for k in ("atlas", "momenta", "epoch_losses", "iter_losses"):
            want = a[k][1:] if k == "epoch_losses" else a[k][...]
            np.testing.assert_allclose(b[k][...], want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_cli_help(monkeypatch, capsys):
    with pytest.raises(SystemExit) as e:
        run_tool(["--help"], monkeypatch)
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "lddmm" in out and "affine" in out and "data" in out and "not ported" not in out
    with pytest.raises(SystemExit) as e:
        run_tool(["data", "--help"], monkeypatch)
    out = capsys.readouterr().out
    assert all(verb in out for verb in ("average", "crop", "downscale", "numexpr", "split",
                                        "splitcv")), out
    for verb, flags in (("average", ("--h5key", "--output_h5key", "--batch_size")),
                        ("downscale", ("--key", "--scale", "--copy_other_keys")),
                        ("crop", ("--slices", "--copy_other_keys")),
                        ("numexpr", ("--expression", "--copy_other_keys")),
                        ("split", ("--h5keys", "--test_size", "--random_seed", "--stratify_key")),
                        ("splitcv", ("--num_folds", "--random_seed", "--stratify_key"))):
        with pytest.raises(SystemExit) as e:
            run_tool(["data", verb, "--help"], monkeypatch)
        assert e.value.code == 0
        out = capsys.readouterr().out
        assert all(flag in out for flag in flags) and "--device" not in out, out
    with pytest.raises(SystemExit) as e:
        run_tool(["lddmm", "atlas", "--help"], monkeypatch)
    assert e.value.code == 0
    out = capsys.readouterr().out
    for flag in ("--device", "--gradient_checkpointing", "--deformation_downscale",
                 "--fluid_transform", "--fluid_beta"):
        assert flag in out
    for command, flags in (("atlas", ("--device", "--affine_steps", "--keep_data_on_device")),
                           ("standardize", ("--device", "--rescale", "--copy_other_keys"))):
        with pytest.raises(SystemExit) as e:
            run_tool(["affine", command, "--help"], monkeypatch)
        assert e.value.code == 0
        out = capsys.readouterr().out
        assert all(flag in out for flag in flags), out


def test_cli_fluid_transform_radix(tmp_path, monkeypatch):
    """``--fluid_transform radix`` puts the 3D solves on the radix-2 route
    (K14, K15 on the card; their plain versions here), which gives the
    default route's atlas; the selector is restored afterwards."""
    src = blobs(tmp_path / "imgs.h5", 4, 8, 3)
    routes = []
    route = tfluid.fluid_route

    def spy(shape, params):
        routes.append(route(shape, params))
        return routes[-1]
    monkeypatch.setattr(tfluid, "fluid_route", spy)
    args = ["--device", "cpu", *TRAIN[:-2], "--num_epochs", "1"]
    try:
        run_tool(["lddmm", "atlas", src, str(tmp_path / "radix.h5"), *args,
                  "--fluid_transform", "radix"], monkeypatch)
    finally:
        prev = tfluid.set_fluid_fft_kernel("auto")
    assert prev == "radix" and set(routes) == {"fluid_radix"}
    routes.clear()
    run_tool(["lddmm", "atlas", src, str(tmp_path / "auto.h5"), *args], monkeypatch)
    assert set(routes) == {"fluid_flat"}
    with h5py.File(tmp_path / "radix.h5", "r") as a, h5py.File(tmp_path / "auto.h5", "r") as b:
        for k in ("atlas", "momenta"):
            np.testing.assert_allclose(a[k][...], b[k][...], rtol=0,
                                       atol=1e-5 * np.abs(b[k][...]).max())


@pytest.mark.parametrize("flags,error", [
    # one CPU device, so no mesh: the JAX command's "requires a mesh"
    (["--spatial_shard"], ValueError),
    # the process loader (ported) runs ahead of no refusal
    (["--spatial_shard", "--loader_mode", "process", "--loader_workers", "1"], ValueError),
    ([], RuntimeError),  # the default device, cuda, on a machine without one
], ids=["flags0-NotImplementedError", "flags1-NotImplementedError", "flags2-RuntimeError"])
def test_cli_unported_options_raise(tmp_path, monkeypatch, flags, error):
    if not flags and torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    src = blobs(tmp_path / "imgs.h5", 2, 8, 2)
    device = ["--device", "cpu"] if flags else []
    with pytest.raises(error):
        run_tool(["lddmm", "atlas", src, str(tmp_path / "out.h5"), "--num_epochs", "1",
                  *device, *flags], monkeypatch)
    assert not os.path.exists(tmp_path / "out.h5")


def test_cli_loaders_match_the_default(tmp_path, monkeypatch):
    """``--loader_mode process --loader_workers 2`` and
    ``--dataloader_cache`` write the atlas, momenta and losses of the
    default synchronous staging exactly."""
    src = blobs(tmp_path / "imgs.h5", 5, 8, 2)
    monkeypatch.setenv("LM_PREFETCH_TIMEOUT", "30")
    args = ["--device", "cpu", *TRAIN]
    outs = {}
    for name, flags in (("default", []),
                        ("process", ["--loader_mode", "process", "--loader_workers", "2"]),
                        ("cache", ["--loader_mode", "process", "--loader_workers", "2",
                                   "--dataloader_cache", str(tmp_path / "cache")])):
        outs[name] = str(tmp_path / f"{name}.h5")
        run_tool(["lddmm", "atlas", src, outs[name], *args, *flags], monkeypatch)
    with h5py.File(outs["default"], "r") as ref:
        for name in ("process", "cache"):
            with h5py.File(outs[name], "r") as f:
                for k in KEYS:
                    np.testing.assert_array_equal(f[k][...], ref[k][...])


@pytest.fixture
def image_h5(tmp_path, rng):
    """6 Gaussian blobs at 12^2, the file of tests/test_cli.py's workflow."""
    res = 12
    grid = np.stack(np.meshgrid(*[np.arange(res, dtype=float)] * 2, indexing="ij"))
    c = (res - 1) / 2
    imgs = []
    for _ in range(6):
        off = rng.uniform(-1.5, 1.5, 2)
        imgs.append(np.exp(-((grid[0] - c - off[0]) ** 2 + (grid[1] - c - off[1]) ** 2)
                           / (2 * (res / 5) ** 2)))
    fn = str(tmp_path / "imgs.h5")
    with h5py.File(fn, "w") as f:
        f.create_dataset("images", data=np.stack(imgs)[:, None].astype(np.float32))
        f.create_dataset("labels", data=np.arange(6))
    return fn


AFFINE_KEYS = {"atlas", "A", "T", "epoch_losses", "iter_losses"}
AFFINE_TOL = 1e-5  # float32, of max|ref|
AFFINE_TRAIN = ["--num_epochs", "3", "--batch_size", "4", "--learning_rate_I", "10",
                "--learning_rate_T", "0.5"]


def test_cli_affine_atlas_and_standardize_match_jax(image_h5, tmp_path, monkeypatch):
    """``affine atlas --device cpu`` (an uneven last batch) writes what the
    JAX package's command writes from the same file, with the provenance
    on ``atlas``; ``affine standardize`` of either package reads the
    other's atlas file, and the port's copies the other keys."""
    out = {name: str(tmp_path / f"atlas_{name}.h5") for name in ("port", "jax")}
    run_module("lagomorph_tpu_torch", ["affine", "atlas", image_h5, out["port"], "--device", "cpu",
                                       *AFFINE_TRAIN])
    run_module("lagomorph_tpu", ["affine", "atlas", image_h5, out["jax"], *AFFINE_TRAIN])
    files = {}
    for name, fn in out.items():
        with h5py.File(fn, "r") as f:
            assert set(f.keys()) == AFFINE_KEYS
            files[name] = {k: f[k][...] for k in AFFINE_KEYS}
            if name == "port":
                assert f["atlas"].attrs["lagomorph_version"] == lt.__version__
                assert '"device": "cpu"' in f["atlas"].attrs["command_args"]
                I, A, T = convert.affine_state_from_saved(f, "cpu")
                assert I.shape == (1, 1, 12, 12) and A.shape == (6, 2, 2) and T.shape == (6, 2)
                np.testing.assert_array_equal(T.numpy(), f["T"][...])
    errs = {}
    for k in AFFINE_KEYS:
        got, want = files["port"][k], files["jax"][k]
        assert got.shape == want.shape and got.dtype == want.dtype, k
        errs[k] = float(np.abs(got - want).max() / np.abs(want).max())
    print("affine atlas, port against JAX, of max|ref|:", errs)
    assert max(errs.values()) <= AFFINE_TOL, errs
    assert files["port"]["epoch_losses"][-1] < files["port"]["epoch_losses"][0]
    assert np.abs(files["port"]["T"]).max() > 1e-3

    std = {"port": str(tmp_path / "std_port.h5"), "port_of_jax": str(tmp_path / "std_pj.h5"),
           "jax_of_port": str(tmp_path / "std_jp.h5")}
    run_tool(["affine", "standardize", image_h5, out["port"], std["port"], "--device", "cpu",
              "--copy_other_keys"], monkeypatch)
    run_tool(["affine", "standardize", image_h5, out["jax"], std["port_of_jax"], "--device", "cpu"],
             monkeypatch)
    run_module("lagomorph_tpu", ["affine", "standardize", image_h5, out["port"],
                                 std["jax_of_port"]])
    imgs = {}
    for name, fn in std.items():
        with h5py.File(fn, "r") as f:
            imgs[name] = f["images"][...]
            assert imgs[name].shape == (6, 1, 12, 12) and imgs[name].dtype == np.float32
            if name == "port":
                assert set(f.keys()) == {"images", "labels"}
                assert "command_args" in f["images"].attrs
                np.testing.assert_array_equal(f["labels"][...], np.arange(6))
                assert f["images"].chunks == (1, 1, 12, 12)
    ref = imgs["jax_of_port"]
    for name in ("port", "port_of_jax"):
        np.testing.assert_allclose(imgs[name], ref, rtol=0, atol=AFFINE_TOL * np.abs(ref).max())


@pytest.mark.parametrize("command", ["atlas", "standardize"])
@pytest.mark.parametrize("flags,error", [
    ([], RuntimeError),  # the default device, cuda, on a machine without one
])
def test_cli_affine_unported_options_raise(image_h5, tmp_path, monkeypatch, command, flags,
                                           error):
    if not flags and torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    files = [image_h5, str(tmp_path / "out.h5")]
    if command == "standardize":
        files.insert(1, str(tmp_path / "atlas.h5"))
    argv = ["affine", command, *files, *(["--device", "cpu"] if flags else []), *flags]
    if command == "atlas":
        argv += ["--num_epochs", "1"]
    with pytest.raises(error):
        run_tool(argv, monkeypatch)
    assert not os.path.exists(tmp_path / "out.h5")


@pytest.fixture
def selectors():
    """The port's global warp mode and fluid selectors, restored to their
    defaults after the test (a command leaves what its flags set)."""
    yield
    lt.set_warp_mode("auto")
    tfluid.set_fluid_fft_kernel("auto")
    tfluid.set_fluid_packing("auto")


def test_cli_lddmm_atlas_warp_mode_general(image_h5, tmp_path, monkeypatch, selectors):
    """``lddmm atlas --warp_mode general --fluid_transform packed`` (the
    flags of tests/test_cli.py's run of the JAX command) leaves the global
    mode "general", runs no unit-regime kernel wrapper, and writes what the
    JAX command writes with the same flags (float32 tolerances as the
    default command's test above)."""
    from lagomorph_tpu_torch.ops.kernels import epdiff2d, shoot2d

    calls = []
    for module, name in ((shoot2d, "shoot2d"), (epdiff2d, "ad_star2d"),
                         (epdiff2d, "compose2d")):
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, fn=fn, name=name, **k: calls.append(name)
                            or fn(*a, **k))
    flags = ["--num_epochs", "1", "--batch_size", "2", "--lddmm_integration_steps", "2",
             "--fluid_transform", "packed", "--warp_mode", "general"]
    out = {name: str(tmp_path / f"{name}.h5") for name in ("port", "jax")}
    run_tool(["lddmm", "atlas", image_h5, out["port"], "--device", "cpu", *flags], monkeypatch)
    assert lt.ops.get_warp_mode() == "general" and not calls, calls
    run_module("lagomorph_tpu", ["lddmm", "atlas", image_h5, out["jax"], *flags])
    with h5py.File(out["port"], "r") as a, h5py.File(out["jax"], "r") as b:
        assert '"warp_mode": "general"' in a["atlas"].attrs["command_args"]
        for k, tol in (("atlas", 1e-5), ("momenta", 1e-4), ("epoch_losses", 1e-5),
                       ("iter_losses", 1e-5)):
            want = b[k][...]
            np.testing.assert_allclose(a[k][...], want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("command", ["atlas", "standardize"])
def test_cli_affine_warp_mode_unit(image_h5, tmp_path, monkeypatch, selectors, command):
    """``affine atlas`` and ``affine standardize`` take ``--warp_mode
    unit``: they run (their warp is the general gather, which the mode does
    not touch), write their file, and leave the global mode set."""
    atlas = str(tmp_path / "atlas.h5")
    run_tool(["affine", "atlas", image_h5, atlas, "--device", "cpu", "--num_epochs", "1",
              *(["--warp_mode", "unit"] if command == "atlas" else [])], monkeypatch)
    out = atlas
    if command == "standardize":
        assert lt.ops.get_warp_mode() == "auto"
        out = str(tmp_path / "std.h5")
        run_tool(["affine", "standardize", image_h5, atlas, out, "--device", "cpu",
                  "--warp_mode", "unit"], monkeypatch)
    assert lt.ops.get_warp_mode() == "unit"
    with h5py.File(out, "r") as f:
        data = f["atlas" if command == "atlas" else "images"]
        assert np.isfinite(data[...]).all() and '"warp_mode": "unit"' in data.attrs["command_args"]
