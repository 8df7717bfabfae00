"""Port parity, config: the port's built-in copy of config/defaults.yaml,
expanded against the environment, equals the JAX package's YAML load under
the same environment (so a change to defaults.yaml that is not copied into
qpp_fusion_rag_tpu_torch/config.py fails here); the QPP name lookup, the
placeholder expansion (its 10-pass cap too), overrides, dataset detection
and the optional YAML file load agree with JAX."""

import importlib

import pytest

from qpp_fusion_rag_tpu_torch import config as TC

JC = importlib.import_module("qpp_fusion_rag_tpu.config")


@pytest.fixture
def clean_env(monkeypatch):
    for var in ("QPP_CONFIG", "BEIR_PATH", "LLM_URL", "PROJECT_ROOT"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


@pytest.mark.parametrize("env", [
    {},
    {"BEIR_PATH": "/data/beir", "LLM_URL": "http://127.0.0.1:9/v1"},
    {"PROJECT_ROOT": "/srv/qpp"},
])
def test_to_dict_equals_jax_under_the_same_environment(clean_env, env):
    for var, value in env.items():
        clean_env.setenv(var, value)
    assert TC.Config.load().to_dict() == JC.Config.load().to_dict()
    assert TC.PROJECT_ROOT == JC.PROJECT_ROOT


def test_module_config_equals_jax():
    assert TC.config.to_dict() == JC.config.to_dict()
    assert TC.config.paths.cache_root.endswith("/cache")
    assert "${" not in TC.config.paths.beir_datasets


def test_get_qpp_index_equals_jax_for_every_name_and_layout():
    t, j = TC.Config.load(), JC.Config.load()
    names = (list(t.qpp.methods) + list(t.qpp.method_index.keys())
             + ["fusion", "FUSION", "rsd", "sigma_max", "Sigma(%)", "scnqc", "nqc"])
    for layout in ("kernel", "reference"):
        for name in names:
            try:
                want = j.get_qpp_index(name, layout=layout)
            except KeyError:
                with pytest.raises(KeyError):
                    t.get_qpp_index(name, layout=layout)
                continue
            assert t.get_qpp_index(name, layout=layout) == want, (name, layout)
    for bad in ("nope", "QPP-PRP"):
        with pytest.raises(KeyError):
            t.get_qpp_index(bad)
        with pytest.raises(KeyError):
            j.get_qpp_index(bad)


def test_expand_matches_jax_and_caps_self_reference():
    env = {"A": "x", "B": "${A}/y", "NEST": "n"}
    for value in ("${A}", "${MISSING:d}", "${MISSING}", "${B}", "${Z:${NEST}/s}", "plain"):
        assert TC._expand(value, env) == JC._expand(value, env)
    loop = {"LOOP": "x${LOOP}"}
    for mod in (TC, JC):
        with pytest.raises(ValueError, match="did not converge"):
            mod._expand("${LOOP}", loop)
    tree = {"a": ["${A}", {"b": "${B}"}], "c": 3}
    assert TC._expand_tree(tree, env) == JC._expand_tree(tree, env)


def test_overrides_dataset_and_detection():
    over = {"training": {"mlp": {"epochs": 7}}, "new": 1}
    t, j = TC.Config.load(overrides=over), JC.Config.load(overrides=over)
    assert t.to_dict() == j.to_dict()
    assert t.training.mlp.epochs == 7 and t.training.mlp.patience == 15
    assert t.dataset("scifact").to_dict() == j.dataset("scifact").to_dict()
    with pytest.raises(KeyError):
        t.dataset("msmarco")
    with pytest.raises(AttributeError, match="read-only"):
        t.training = 1
    for path in ("/x/BEIR-scifact/corpus.jsonl", "/home/tanq/x", "/d/nq_hotpotqa/x",
                 "runs/hotpotqa-dev.res", "/nothing/here"):
        assert TC.detect_dataset(path) == JC.detect_dataset(path)
    assert TC._deep_merge({"a": {"b": 1, "c": 2}}, {"a": {"b": 3}}) == {"a": {"b": 3, "c": 2}}


def test_load_reads_a_user_yaml_file_like_jax(clean_env, tmp_path):
    """A path (or QPP_CONFIG) reads YAML through pyyaml, here where it is
    installed; tests/test_torch_train.py loads without it and gets an
    ImportError naming pyyaml."""
    path = tmp_path / "user.yaml"
    path.write_text("paths:\n  cache_root: ${PROJECT_ROOT}/c\nqpp:\n  n_methods: 13\n")
    assert TC.Config.load(path).to_dict() == JC.Config.load(path).to_dict()
    clean_env.setenv("QPP_CONFIG", str(path))
    assert TC.Config.load().to_dict() == JC.Config.load().to_dict() == {
        "paths": {"cache_root": f"{TC.PROJECT_ROOT}/c"}, "qpp": {"n_methods": 13}}


def test_builtin_defaults_copy_the_yaml_file():
    """DEFAULTS is config/defaults.yaml as yaml.safe_load reads it, the
    placeholders unexpanded; Config.load() hands out copies of it."""
    import yaml

    with open(TC.DEFAULT_CONFIG_PATH) as f:
        assert TC.DEFAULTS == yaml.safe_load(f)
    assert TC.DEFAULT_CONFIG_PATH == JC.DEFAULT_CONFIG_PATH
    cfg = TC.Config.load()
    cfg.to_dict()["training"]["mlp"]["epochs"] = -1
    assert TC.DEFAULTS["training"]["mlp"]["epochs"] == 100
