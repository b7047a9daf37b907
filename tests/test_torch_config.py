"""The port's conf parser and config translation against neat_tpu's.

Every conf under confs/ must give the same parsed dict, the same resolved
ExperimentConfig (``dataclasses.asdict``, every field of every nested
config) and the same ``dump_hocon`` text in both packages, exactly. Each
conf is a case of its own.
"""

import dataclasses
import glob
import os.path as osp

import pytest

import neat_tpu.train.config as jconf
import neat_tpu_torch.train.config as tconf
from neat_tpu_torch.model.neat import check_ported, init_neat

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFS = sorted(osp.relpath(p, REPO) for p in glob.glob(osp.join(REPO, "confs", "**", "*.conf"), recursive=True))


def test_every_conf_is_a_case():
    assert len(CONFS) == 8


def _text(conf):
    with open(osp.join(REPO, conf)) as f:
        return f.read()


@pytest.mark.parametrize("conf", CONFS)
def test_conf_parses_to_the_same_dict(conf):
    assert tconf.parse_hocon(_text(conf)) == jconf.parse_hocon(_text(conf))


@pytest.mark.parametrize("conf", CONFS)
def test_conf_resolves_to_the_same_config(conf):
    a = jconf.load_experiment_config(osp.join(REPO, conf))
    b = tconf.load_experiment_config(osp.join(REPO, conf))
    assert dataclasses.asdict(b) == dataclasses.asdict(a)


@pytest.mark.parametrize("conf", CONFS)
def test_dump_hocon_gives_the_same_text_and_reparses(conf):
    raw = jconf.parse_hocon(_text(conf))
    text = tconf.dump_hocon(raw)
    assert text == jconf.dump_hocon(raw)
    assert tconf.parse_hocon(text) == jconf.parse_hocon(text)


OVERRIDES = [
    dict(scan_id=65),
    dict(nepochs=7),
    dict(max_verts=64),
    dict(assignment_method="callback"),
    dict(scan_id=3, nepochs=1, max_verts=16),
]


@pytest.mark.parametrize("conf", ["confs/abc-neat-a.conf", "confs/dtu.conf"])
@pytest.mark.parametrize("kw", OVERRIDES, ids=lambda kw: "-".join(kw))
def test_cli_overrides_resolve_the_same(conf, kw):
    a = jconf.load_experiment_config(osp.join(REPO, conf), **kw)
    b = tconf.load_experiment_config(osp.join(REPO, conf), **kw)
    assert dataclasses.asdict(b) == dataclasses.asdict(a)


DIALECT = """
# a comment
a {
    b = 1   // trailing comment
    c = "quoted # not a comment"
    inline { beta = 0.1 }
    lst = [1, 2.5, x]
    flag = yes
}
brace_next
{
    d = -3
    e = 1e-4
    f: false
}
"""


def test_dialect_parses_the_same():
    assert tconf.parse_hocon(DIALECT) == jconf.parse_hocon(DIALECT)
    for bad in ("a\nb = 1\n", "a = 1\n!!\n"):
        with pytest.raises(ValueError):
            jconf.parse_hocon(bad)
        with pytest.raises(ValueError):
            tconf.parse_hocon(bad)


def test_class_maps_are_the_same():
    assert tconf._DATASET_CLASS_MAP == jconf._DATASET_CLASS_MAP
    assert tconf._MODEL_CLASS_MAP == jconf._MODEL_CLASS_MAP
    assert tconf._LOSS_CLASS_MAP == jconf._LOSS_CLASS_MAP


@pytest.mark.parametrize("conf", ["confs/abc/abc-1776.conf", "confs/dtu.conf"])
def test_dbscan_confs_pass_check_ported_and_build(conf):
    """The DBSCAN confs resolve as in JAX, pass check_ported and build the
    model (1024 junction latents on DTU, 64 on ABC)."""
    cfg = tconf.load_experiment_config(osp.join(REPO, conf))
    assert cfg.model.dbscan_enabled and not cfg.model.use_median
    check_ported(cfg.model)
    model = init_neat(cfg.model, seed=0, device="cpu")
    assert model.junctions.latents.shape[0] == (1024 if "dtu" in conf else 64)


@pytest.mark.parametrize("conf", CONFS)
def test_every_conf_passes_check_ported(conf):
    check_ported(tconf.load_experiment_config(osp.join(REPO, conf)).model)


def test_dbscan_with_global_junctions_still_raises():
    """rend_c (the global junctions joined to the endpoints before DBSCAN)
    parses as in JAX; once a raise naming the variants item, the model now
    builds with its junction head (tests/test_torch_variants.py trains it
    against JAX)."""
    conf = tconf.parse_hocon(_text("confs/dtu.conf"))
    conf["train"]["model_class"] = "model.networks.neat_wfr_rend_c.VolSDFNetwork"
    cfg = tconf.build_experiment_config(conf)
    assert cfg.model.dbscan_include_global and cfg.model.dbscan_enabled
    check_ported(cfg.model)
    assert init_neat(cfg.model, seed=0, device="cpu").junctions.latents.shape[0] == 1024
