"""The port's checkpoints: exact save and load, the fallback from a damaged
``latest.ckpt``, and the ModelParameters export under the JAX package's
keys (held against neat_tpu's own export of the same conf's model)."""

import dataclasses
import os
import os.path as osp
import pickle

import jax
import numpy as np
import pytest
import torch

import neat_tpu.model.neat as jneat
import neat_tpu.train.checkpoint as jckpt
import neat_tpu.train.config as jconf
import neat_tpu.train.step as jstep
import neat_tpu_torch.train.checkpoint as tckpt
import neat_tpu_torch.train.config as tconf
from _torch_helpers import configs
from neat_tpu_torch.model.neat import init_neat
from neat_tpu_torch.train.step import init_train_state

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _state(seed):
    """A small train state with every tensor drawn from ``seed``."""
    _, cfg = configs()
    state = init_train_state(init_neat(cfg, seed=seed, device="cpu"))
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p, mu, nu in zip(state.model.parameters(), state.mu, state.nu):
            p.add_(torch.randn(p.shape, generator=gen))
            mu.copy_(torch.randn(mu.shape, generator=gen))
            nu.copy_(torch.rand(nu.shape, generator=gen))
    state.step = 1000 + seed
    return state


def _bits(t):
    return t.detach().cpu().numpy().tobytes()


def _same(a, b):
    return (
        a.step == b.step
        and all(_bits(x) == _bits(y) for x, y in zip(a.model.state_dict().values(), b.model.state_dict().values()))
        and all(_bits(x) == _bits(y) for x, y in zip(a.mu, b.mu))
        and all(_bits(x) == _bits(y) for x, y in zip(a.nu, b.nu))
    )


def test_save_load_is_bit_exact(tmp_path):
    saved = _state(1)
    tckpt.save_checkpoint(str(tmp_path), saved, epoch=7)
    for tag in ("7", "latest"):
        host, epoch = tckpt.load_checkpoint(str(tmp_path), tag)
        fresh = _state(2)
        assert not _same(fresh, saved)
        tckpt.restore_state(fresh, host)
        assert epoch == 7 and _same(fresh, saved)


def test_payload_holds_no_torch_object(tmp_path):
    tckpt.save_checkpoint(str(tmp_path), _state(3), epoch=0)
    with open(tmp_path / "latest.ckpt", "rb") as f:
        payload = pickle.load(f)
    st = payload["state"]
    assert set(st) == {"params", "mu", "nu", "step"} and isinstance(st["step"], int)
    for part in ("params", "mu", "nu"):
        assert all(type(v) is np.ndarray for v in st[part].values())


@pytest.mark.parametrize("damage", ["truncated", "missing"])
def test_damaged_latest_falls_back_to_the_newest_epoch_tag(tmp_path, damage):
    states = {}
    for epoch in (0, 1, 2):
        states[epoch] = _state(10 + epoch)
        tckpt.save_checkpoint(str(tmp_path), states[epoch], epoch)
    latest = tmp_path / "latest.ckpt"
    if damage == "truncated":
        latest.write_bytes(latest.read_bytes()[:1000])
    else:
        latest.unlink()
    host, epoch = tckpt.load_checkpoint(str(tmp_path))
    fresh = _state(0)
    tckpt.restore_state(fresh, host)
    assert epoch == 2 and _same(fresh, states[2])
    # the newest tag damaged too: the one before it
    (tmp_path / "2.ckpt").write_bytes(b"\x80\x04")
    host, epoch = tckpt.load_checkpoint(str(tmp_path))
    assert epoch == 1 and host["step"] == states[1].step
    for name in ("0.ckpt", "1.ckpt"):
        (tmp_path / name).write_bytes(b"")
    with pytest.raises(RuntimeError, match="no earlier epoch tag"):
        tckpt.load_checkpoint(str(tmp_path))


def test_atomic_write_leaves_the_old_file_on_failure(tmp_path):
    path = str(tmp_path / "f.ckpt")
    tckpt._atomic_write(path, lambda f: f.write(b"old"))

    def boom(f):
        f.write(b"half")
        raise OSError("disk full")

    with pytest.raises(OSError):
        tckpt._atomic_write(path, boom)
    assert open(path, "rb").read() == b"old" and os.listdir(tmp_path) == ["f.ckpt"]


@pytest.mark.parametrize("conf", ["confs/abc-neat-a.conf", "confs/dtu.conf"])
def test_model_parameters_export_keys_match_jax(tmp_path, conf):
    """The same conf's model exported by both packages: the same npz keys
    and array shapes."""
    cfg_j = jconf.load_experiment_config(osp.join(REPO, conf)).model
    cfg_t = tconf.load_experiment_config(osp.join(REPO, conf)).model
    # the port builds only the default variant: dtu.conf's DBSCAN flag does
    # not change the parameters, so build both without it
    cfg_j = dataclasses.replace(cfg_j, dbscan_enabled=False)
    cfg_t = dataclasses.replace(cfg_t, dbscan_enabled=False)
    params = jneat.init_neat(jax.random.PRNGKey(0), cfg_j)
    jckpt.save_checkpoint(str(tmp_path / "jax"), jstep.init_train_state(params, 5e-4, 0.1, 100), 0)
    state = init_train_state(init_neat(cfg_t, seed=0, device="cpu"))
    tckpt.save_checkpoint(str(tmp_path / "torch"), state, 0)
    with np.load(tmp_path / "jax" / "ModelParameters" / "0.npz") as a, \
            np.load(tmp_path / "torch" / "ModelParameters" / "0.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k


def test_sweep_checkpoint(tmp_path):
    for stamp, epochs in (("2026_01_01_00_00_00", (0, 1)), ("2026_01_02_00_00_00", (2,))):
        for e in epochs:
            tckpt.save_checkpoint(str(tmp_path / stamp / "checkpoints"), _state(e), e)
    assert tckpt.sweep_checkpoint(str(tmp_path), "1") == "2026_01_01_00_00_00"
    assert tckpt.sweep_checkpoint(str(tmp_path), "2") == "2026_01_02_00_00_00"
    assert tckpt.sweep_checkpoint(str(tmp_path), "5") is None
    with pytest.raises(RuntimeError, match="multiple timestamps"):
        tckpt.sweep_checkpoint(str(tmp_path), "latest")
