"""The zamba2-7b configuration and its training cell, whose driver
(``drivers/train_by_reference.py``) runs ``drivers/train.py`` with the
configuration's own plain reference (``reference/zamba2.py``) bound in:
the file against the catalog's published config and the program's
registered one, the binding, a rehearsal of the cell at a smoke size on
the CPU, and the float8 control reading at least three times a sound run.
The reference is held to the program and to the published modelling code
in ``tests/test_torch_zamba2.py``."""

import dataclasses
import json

import pytest

from perfbench import calibrate, harness
from perfbench.drivers import train as train_driver
from perfbench.drivers import train_by_reference
from perfbench.reference import train as ref_train
from perfbench.reference import zamba2
from perfbench.sizes import ROOT, Sizes, load_config

from .test_perfbench_harness import BENCH, _well_formed

CELL = "zamba2-7b-train-2x4096"
CONFIG = load_config("zamba2-7b")
# port key -> published key
WIDTHS = {"d_model": "hidden_size", "num_heads": "num_attention_heads",
          "num_kv_heads": "num_key_value_heads",
          "head_dim": "attention_head_dim", "d_ff": "ffn_hidden_size",
          "vocab_size": "vocab_size", "adapter_rank": "adapter_rank",
          "shared_blocks": "num_mem_blocks", "ssm_state": "mamba_d_state",
          "ssm_head_dim": "mamba_headdim", "ssm_expand": "mamba_expand",
          "ssm_groups": "mamba_ngroups", "ssm_chunk": "chunk_size",
          "ssm_conv": "mamba_d_conv", "rope_theta": "rope_theta"}
SMOKE = dict(num_layers=12, d_model=64, d_ff=128, vocab_size=512,
             num_heads=4, num_kv_heads=4, head_dim=32, adapter_rank=8,
             ssm_head_dim=16, ssm_state=16, ssm_chunk=32,
             decode_hot_len=16, loss_chunk=256)
TRAFFIC = {"batch": 2, "seq_len": 48}
SEED = 987654321987


def test_file_holds_the_published_config_as_run():
    published = CONFIG["published"]
    for key, value in published.items():
        if key not in CONFIG["reduced"]:
            assert CONFIG[key] == value, key
    for key in CONFIG["reduced"]:
        assert any(d.startswith(key + ":") for d in CONFIG["departures"])
    port = CONFIG["port"]
    for port_key, key in WIDTHS.items():
        assert port[port_key] == published[key], port_key
    # the zamba_hybrid kind fixes the attention's width (the concatenation
    # [x ; e]) and the feed-forward's activation (exact GELU)
    assert 2 * port["d_model"] == published["attention_hidden_size"]
    assert published["hidden_act"] == "gelu"
    assert port["ssm_expand"] * port["d_model"] // port["ssm_head_dim"] \
        == published["n_mamba_heads"]
    assert CONFIG["num_hidden_layers"] == port["num_layers"] == 24
    assert CONFIG["layers_block_type"].count("hybrid") == 4
    s = Sizes.of(port)
    assert (s.repeats, s.head_dim, s.ssm_heads, s.padded_vocab) == (
        4, 224, 112, 32000)
    entry = {c["name"]: c for c in BENCH["configs"]}["zamba2-7b"]
    assert entry["reduced"] == CONFIG["reduced"]
    assert entry["source"] == CONFIG["source"]


def test_port_section_is_the_registered_config():
    from repro_torch.configs import get_config

    registered = json.loads(json.dumps(dataclasses.asdict(
        get_config("zamba2-7b"))))
    for key in CONFIG["resized"]:
        registered[key] = CONFIG["port"][key]
    assert CONFIG["port"] == registered


def test_binding_swaps_the_four_names_and_restores_them():
    from repro_torch.configs import HybridConfig, get_config

    before = {n: getattr(train_driver, n) for n in train_by_reference.NAMES}
    steps = ref_train.reference_steps
    model_config = harness.Cell.model_config
    cell = harness.load_cell(CELL, SEED, 1.0, False, "cpu")
    with train_by_reference.bound(CONFIG, control=True) as names:
        for n in train_by_reference.NAMES:
            assert getattr(train_driver, n) is names[n]
        assert ref_train.reference_steps is names["reference_steps"]
        # the cell's program config is the registered one at 24 layers
        cfg = cell.model_config()
        assert isinstance(cfg, HybridConfig)
        assert cfg == dataclasses.replace(get_config("zamba2-7b"),
                                          num_layers=24)
        s = Sizes.of(CONFIG["port"])
        # 177.6 TFLOP a step at 2 x 4096 (remat's recompute not counted,
        # as work/model_flops.py counts), 41% of it the shared blocks'
        # products and attention
        mf = names["model_flops"]
        step = mf.train_step(s, 2, 4096)
        assert round(step / 1e12, 1) == 177.6
        apps = mf.applications(s)
        shared = (6.0 * apps * mf.shared_params(s) * 8192
                  + apps * zamba2._attention_flops(s, 2, 4096))
        assert apps == 4 and round(shared / step, 2) == 0.41
    assert {n: getattr(train_driver, n) for n in before} == before
    assert ref_train.reference_steps is steps
    assert harness.Cell.model_config is model_config


def _smoke_cell(trace, limits=None):
    return harness.load_cell(CELL, SEED, 4.0, trace, "cpu", {
        "port": SMOKE, "traffic": TRAFFIC, "limits": limits or {}})


def test_cpu_rehearsal_prints_a_well_formed_line(capsys):
    cell = _smoke_cell(True)
    rec = harness.run_cell(cell)
    line = harness.print_result(cell, rec, 1.5)
    out, _ = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == json.loads(
        json.dumps(line))
    _well_formed(line, CELL, True)
    assert line["metrics"]["shared_block_busy_ms.train"]["value"] > 0
    assert rec["checks"]["talp_invalid"]["value"] == 0
    assert (ROOT / "limits" / f"{CELL}.json").is_file()


def test_control_reads_three_times_a_sound_run():
    work = {w["name"]: w for w in BENCH["workloads"]}[CELL]
    smoke = {**CONFIG, "port": {**CONFIG["port"], **SMOKE}}
    with train_by_reference.bound(smoke, control=True):
        out = calibrate.readings(work, [SEED], control=1, faults=1,
                                 device="cpu", overrides={
                                     "port": SMOKE, "traffic": {
                                         **TRAFFIC, "driver": "train"}})
    sound, control = out["sound"][SEED], out["control"][SEED]
    fault = out["fault"][SEED]
    for key in ("grad_diff", "change_diff"):
        assert control[key] >= 3 * sound[key], (key, control, sound)
    assert fault["loss_rel"] >= 3 * sound["loss_rel"]
