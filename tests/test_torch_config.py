"""The port's config layer (M7) against the JAX package's: the config files
are byte copies, the YAML-subset reader gives `yaml.safe_load`'s trees,
composition (base, each experiment, dotted overrides) gives the same
`Config` tree, and snapshots written by either package load in the other.
Everything here is exact equality."""

import math
from pathlib import Path

import pytest
import yaml

from basd_tpu import config as jconfig
from basd_tpu_torch import config as tconfig
from basd_tpu_torch.utils import yaml_subset

ROOT = Path(__file__).resolve().parents[1]
JAX_CONFIGS = ROOT / "basd_tpu" / "configs"
PORT_CONFIGS = ROOT / "basd_tpu_torch" / "configs"
FILES = sorted(p.relative_to(JAX_CONFIGS).as_posix() for p in JAX_CONFIGS.rglob("*.yaml"))
EXPERIMENTS = sorted(p.stem for p in (JAX_CONFIGS / "experiment").glob("*.yaml"))

OVERRIDE_VALUES = [
    "1", "-3", "0", "017", "0x1f", "0b101", "1_000", "+12", "1:30",
    "1.0e-3", "5.0e-4", "1e-3", "1.0e+17", ".5", "1.", "-0.0", "3.14",
    "-.inf", ".inf", ".nan", "yes", "No", "on", "OFF", "true", "False",
    "null", "~", "", "auto", "synthetic/cifar100-like-1024n", "chiprun_out/m7",
    "/tmp/a b/c", "a#b", "a # comment", "'it''s'", '"\\u00e9\\x41\\t"',
    "{embed_dim: 192, depth: 12, num_heads: 3, mlp_ratio: 4.0}",
    "[]", "{}", "[1, 2.5, a, 'b c', \"d\"]", "{a: [1, {b: null}], c: 'x: y'}",
    "[barkermrl/imagenet-a, songweig/imagenet_sketch]",
]


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return a == b and type(a) is type(b)


@pytest.mark.parametrize("name", FILES)
def test_config_files_are_byte_copies(name):
    assert (PORT_CONFIGS / name).read_bytes() == (JAX_CONFIGS / name).read_bytes()


def test_every_config_file_is_copied():
    port = sorted(p.relative_to(PORT_CONFIGS).as_posix() for p in PORT_CONFIGS.rglob("*.yaml"))
    assert port == FILES and len(FILES) == 5


@pytest.mark.parametrize("name", FILES)
def test_reader_gives_safe_loads_tree_on_config_files(name):
    text = (JAX_CONFIGS / name).read_text()
    assert yaml_subset.load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("raw", OVERRIDE_VALUES)
def test_reader_gives_safe_loads_value_on_overrides(raw):
    assert _same(yaml_subset.load(raw), yaml.safe_load(raw)), raw


TRICKY = {
    "run": {"name": "x", "output_dir": "/tmp/pytest of root/a long path " * 4,
            "seed": 42},
    "data": {"eval_datasets": [], "m": {},
             "list": ["a", "b: c", "yes", "1.0", None, 1e-5, 1e17, -2, True]},
    "nested": [{"a": 1, "b": [1, 2]}, [3, [4]], "#x", "-x", " lead", "tab\tin",
               "nl\nin", "two\n\nbreaks", "é", "'q'", '"dq"', "a: b",
               "${num_classes:x}"],
    "floats": [0.1, 1 / 3, float("inf"), -float("inf"), 5e-4, 1.0, 100.0, 1e-300],
}


def test_writer_output_reads_back_in_both_readers():
    text = yaml_subset.dump(TRICKY)
    assert yaml_subset.load(text) == TRICKY
    assert yaml.safe_load(text) == TRICKY


@pytest.mark.parametrize("style", [
    {}, {"default_flow_style": True}, {"width": 20}, {"indent": 4},
])
def test_reader_reads_pyyamls_output(style):
    text = yaml.safe_dump(TRICKY, sort_keys=False, **style)
    assert yaml_subset.load(text) == TRICKY


@pytest.mark.parametrize("text", [
    "a: &x 1\nb: *x\n", "a: !!str 1\n", "a: |\n  text\n", "a: >\n  text\n",
    "a: 1\n---\nb: 2\n",
])
def test_reader_refuses_what_it_does_not_take(text):
    with pytest.raises(yaml_subset.YAMLSubsetError):
        yaml_subset.load(text)


def test_base_tree_equals_the_jax_packages():
    assert tconfig.compose_config([]) == jconfig.compose_config([])


@pytest.mark.parametrize("experiment", EXPERIMENTS)
def test_experiment_trees_equal_the_jax_packages(experiment):
    ov = [f"experiment={experiment}"]
    assert tconfig.compose_config(ov) == jconfig.compose_config(ov)


@pytest.mark.parametrize("overrides", [
    ["experiment=basd_cifar100", "data.dataset=synthetic/cifar100-like-1024n",
     "training.num_epochs=1",
     "model.arch_overrides={embed_dim: 192, depth: 12, num_heads: 3, mlp_ratio: 4.0}",
     "checkpoint.save_every_steps=4", "evaluation.efficiency_warmup=5",
     "evaluation.efficiency_batches=20", "run.output_dir=chiprun_out/m7"],
    ["experiment=basd_smoke", "training.learning_rate=1.0e-3", "hardware.remat=false",
     "data.eval_datasets=[]", "basd.subspace_k=auto", "new.key.path=on"],
    ["data.dataset=synthetic/cifar10-like-32px-7c-300n", "model.vit.img_size=24"],
])
def test_overridden_trees_equal_the_jax_packages(overrides):
    got = tconfig.compose_config(overrides)
    assert got == jconfig.compose_config(overrides)
    assert got.model.num_classes == got.to_dict()["model"]["num_classes"]


def test_override_without_equals_raises():
    with pytest.raises(ValueError, match="key=value"):
        tconfig.compose_config(["training.num_epochs"])


def test_port_snapshot_loads_in_the_jax_package(tmp_path):
    config = tconfig.compose_config(["experiment=basd_cifar100"])
    config.model.arch_overrides = {"embed_dim": 192, "depth": 12, "num_heads": 3,
                                   "mlp_ratio": 4.0}
    config.basd.subspace_k = 48
    tconfig.save_config(config, tmp_path / "config.yaml")
    text = (tmp_path / "config.yaml").read_text()
    assert yaml.safe_load(text) == config.to_dict()
    assert jconfig.load_config(tmp_path / "config.yaml") == config
    assert tconfig.load_config(tmp_path / "config.yaml") == config


def test_jax_snapshot_loads_in_the_port(tmp_path):
    config = jconfig.compose_config(["experiment=basd_smoke",
                                     f"run.output_dir={tmp_path / 'a b'}"])
    config.model.arch_overrides = {"embed_dim": 64, "depth": 6, "num_heads": 2,
                                   "mlp_ratio": 4.0}
    jconfig.save_config(config, tmp_path / "config.yaml")
    assert tconfig.load_config(tmp_path / "config.yaml") == config
    ov = ["checkpoint.path=/x/final_model.npz", "evaluation.efficiency_batches=3"]
    assert (tconfig.compose_from_snapshot(tmp_path / "config.yaml", ov)
            == jconfig.compose_from_snapshot(tmp_path / "config.yaml", ov))


def test_config_attribute_access():
    config = tconfig.compose_config(["experiment=basd_smoke"])
    assert config.model.vit.img_size == 16
    assert isinstance(config.model.vit, tconfig.Config)
    with pytest.raises(AttributeError):
        config.no_such_key
