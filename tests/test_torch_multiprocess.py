"""Multi-process data-parallel training through the port's command line:
two processes (``python -m lagomorph_tpu_torch lddmm atlas --device cpu
--coordinator_address ... --num_processes 2 --process_id r``, a gloo
process group) train the LDDMM atlas and must match the port's
single-process builder over the same global batches, as
``tests/test_multiprocess.py`` holds the JAX package's.

This exercises ``Tool``'s process-group flags, the per-process interleaved
shards, the global-count normalisation, the summed losses and atlas
gradient, the ``{rank}`` outputs and the per-rank checkpoints.
"""
import os
import socket
import subprocess
import sys

import h5py
import numpy as np
import pytest

from tests.test_atlas import make_synth_images

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, RES, BATCH, EPOCHS = 16, 12, 4, 2  # subjects, grid, per-process batch, epochs
ARGS = ["--num_epochs", str(EPOCHS), "--batch_size", str(BATCH), "--lddmm_integration_steps",
        "3", "--reg_weight", "0.1", "--learning_rate_m", "1e-3", "--learning_rate_I", "1e2",
        "--fluid_alpha", "0.1", "--fluid_beta", "0.0", "--fluid_gamma", "0.01"]
TIMEOUT_S = 120  # a process that hangs in a collective fails the test, not the suite


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_two(tmp_path, src, extra):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "lagomorph_tpu_torch", "lddmm", "atlas", src,
         str(tmp_path / "out_rank{rank}.h5"), "--device", "cpu",
         "--checkpoint", str(tmp_path / "ckpt_{epoch}_rank{rank}.h5"),
         "--coordinator_address", f"127.0.0.1:{port}", "--num_processes", "2",
         "--process_id", str(r), *ARGS, *extra],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]


def _read(path):
    with h5py.File(path, "r") as f:
        return {k: f[k][...] for k in ("atlas", "momenta", "iter_losses", "epoch_losses")}


@pytest.mark.parametrize("keep", [False, True], ids=["stream", "on_device"])
def test_two_process_atlas_matches_single(rng, tmp_path, keep):
    imgs = make_synth_images(rng, n=N, res=RES)
    src = str(tmp_path / "imgs.h5")
    with h5py.File(src, "w") as f:
        f.create_dataset("images", data=imgs)
    _run_two(tmp_path, src, ["--keep_data_on_device"] if keep else [])
    r0, r1 = (_read(tmp_path / f"out_rank{r}.h5") for r in range(2))

    # each rank's files hold its own subjects' momenta; the last epoch's
    # checkpoint equals the output
    for r, rr in enumerate((r0, r1)):
        assert rr["momenta"].shape[0] == N // 2
        ck = _read(tmp_path / f"ckpt_{EPOCHS - 1}_rank{r}.h5")
        np.testing.assert_array_equal(ck["momenta"], rr["momenta"])
        np.testing.assert_array_equal(ck["atlas"], rr["atlas"])

    # both ranks hold the same atlas and the same global losses
    np.testing.assert_allclose(r0["atlas"], r1["atlas"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(r0["iter_losses"], r1["iter_losses"], rtol=0, atol=1e-7)

    # the single-process run over the global batches: each global batch k
    # joins rank 0's k-th minibatch (subjects 0, 2, ...) and rank 1's
    import lagomorph_tpu_torch as lt

    shard0, shard1 = list(range(0, N, 2)), list(range(1, N, 2))
    order = []
    for k in range(len(shard0) // BATCH):
        order += shard0[k * BATCH:(k + 1) * BATCH] + shard1[k * BATCH:(k + 1) * BATCH]
    builder = lt.LDDMMAtlasBuilder(
        [imgs[i] for i in order], num_epochs=EPOCHS, batch_size=2 * BATCH,
        lddmm_integration_steps=3, reg_weight=0.1, metric=lt.FluidMetric([0.1, 0.0, 0.01]),
        learning_rate_pose=1e-3, learning_rate_image=1e2, progress_bar=False, device="cpu")
    builder.run()
    atlas_sp = builder.I.numpy()
    assert np.abs(r0["atlas"] - atlas_sp).max() <= 1e-4, np.abs(r0["atlas"] - atlas_sp).max()
    np.testing.assert_allclose(r0["iter_losses"], builder.iter_losses, rtol=1e-5, atol=1e-7)

    # per-subject momenta equal the single-process run's, subject by subject
    ms_sp = np.concatenate([np.asarray(m) for m in builder.ms], axis=0)
    mp = {}
    for r, rr in enumerate((r0, r1)):
        for subj, m in zip(range(r, N, 2), rr["momenta"]):
            mp[subj] = m
    assert np.abs(ms_sp).max() > 0
    for pos, subj in enumerate(order):
        np.testing.assert_allclose(mp[subj], ms_sp[pos], rtol=0, atol=1e-6, err_msg=str(subj))
