"""The configuration files against the program's registered configs: the
``port`` section is the program's ``ModelConfig`` as it runs, key for key
(a file whose model the program registers at other sizes names that
config in ``port_of`` and the keys it changes in ``resized``), the
published widths it runs at are the file's ``published`` ones, and
``reduced`` names no width."""

import dataclasses
import json
import re

import pytest

from perfbench.sizes import ROOT, Sizes, load_config

NAMES = sorted(p.stem for p in (ROOT / "configs").glob("*.json"))
# port key -> published key; a dotted key is read inside a nested group
WIDTHS = {
    "mamba2-2.7b": {"d_model": "d_model", "num_layers": "n_layer",
                    "d_ff": "d_intermediate", "vocab_size": "vocab_size",
                    "ssm_state": "layer_defaults.d_state", "ssm_head_dim":
                    "layer_defaults.headdim", "ssm_expand":
                    "layer_defaults.expand", "ssm_conv":
                    "layer_defaults.d_conv", "ssm_groups":
                    "layer_defaults.ngroups", "ssm_chunk":
                    "layer_defaults.chunk_size"},
    "granite-moe-3b-a800m": {"d_model": "hidden_size", "num_layers":
                             "num_hidden_layers", "num_heads":
                             "num_attention_heads", "num_kv_heads":
                             "num_key_value_heads", "moe_d_ff":
                             "intermediate_size", "num_experts":
                             "num_local_experts", "num_experts_per_token":
                             "num_experts_per_tok", "vocab_size":
                             "vocab_size"},
}
# a width, which ``reduced`` may never name
WIDTH_KEY = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                       r"proj|head|expand|experts_per|d_model|d_ff")


def test_every_config_has_its_widths_listed():
    assert sorted(WIDTHS) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_port_section_is_the_registered_config(name):
    from repro_torch.configs import get_config

    cfg = load_config(name)
    port = cfg["port"]
    registered = json.loads(json.dumps(dataclasses.asdict(
        get_config(cfg.get("port_of", name)))))
    for key in cfg.get("resized", []):
        registered[key] = port[key]
    assert port == registered


def _published(cfg, key):
    value = cfg["published"]
    for part in key.split("."):
        value = value[part]
    return value


@pytest.mark.parametrize("name", NAMES)
def test_published_widths_are_the_ones_run(name):
    cfg = load_config(name)
    for port_key, published_key in WIDTHS[name].items():
        assert cfg["port"][port_key] == _published(cfg, published_key), (
            port_key, published_key)
    for key in cfg["reduced"]:
        assert not WIDTH_KEY.search(key), key
        assert any(d.startswith(key + ":") for d in cfg["departures"]), key


def test_mamba2_heads_and_vocabulary():
    s = Sizes.of(load_config("mamba2-2.7b")["port"])
    assert (s.ssm_heads, s.ssm_d_inner, s.repeats) == (80, 5120, 64)
    assert s.pattern == ("ssm",) and s.padded_vocab == 50432


def test_granite_experts_and_vocabulary():
    s = Sizes.of(load_config("granite-moe-3b-a800m")["port"])
    assert (s.num_experts, s.top_k, s.experts_physical) == (40, 8, 48)
    assert (s.head_dim, s.padded_vocab) == (64, 49408)


BENCH_CONFIGS = json.loads((ROOT.parent / "BENCHMARK.json").read_text())[
    "configs"]


@pytest.mark.parametrize("entry", BENCH_CONFIGS, ids=lambda c: c["name"])
def test_benchmark_entry_names_the_file(entry):
    name = entry["name"]
    assert entry["file"] == f"perfbench/configs/{name}.json"
    assert entry["reduced"] == load_config(name)["reduced"]
    assert entry["source"] in load_config(name)["source"]
