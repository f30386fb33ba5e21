"""stjep_tpu_torch/scripts/quality.py, the port of scripts/measure_quality.py,
on the CPU: its settings equal the JAX script's, the gate on both sides of
each bound, the profiles against the fused LAS kernels' gates, the route
check on recorded launches, and one short tiny run through every stage,
whose joint checkpoint the JAX package decodes to the port's lines."""

import importlib.util
import json
from pathlib import Path

import pytest

import translate as jax_tr
from stjep_tpu.config import ModelConfig as JaxModelConfig
from stjep_tpu.data.dataset import Dataset as JaxDataset
from stjep_tpu.ops.las_flash import las_flash_supported as jax_las_flash_supported
from stjep_tpu.ops.las_tf_flash import las_tf_flash_supported as jax_las_tf_flash_supported

from stjep_tpu_torch.config import ModelConfig
from stjep_tpu_torch.ops.las_flash import las_flash_supported
from stjep_tpu_torch.ops.las_tf_flash import las_tf_flash_supported
from stjep_tpu_torch.scripts import quality

ROOT = Path(__file__).resolve().parents[1]


def _jax_script(name):
    """A module of the repo's scripts/ (it imports no JAX at import)."""
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def mq():
    return _jax_script("measure_quality")


def test_settings_equal_measure_quality(mq):
    assert quality.PROFILES == mq.PROFILES and quality.JOINT_HP == mq.JOINT_HP
    assert (quality.N_TRAIN, quality.N_DEV, quality.EPOCHS_ASR, quality.EPOCHS_JOINT) == (
        mq.N_TRAIN, mq.N_DEV, mq.EPOCHS_ASR, mq.EPOCHS_JOINT) == (360, 48, 80, 80)
    for dims in mq.PROFILES.values():
        assert quality.common_flags("/d", dims) == mq.common_flags("/d", dims)
    src = (ROOT / "scripts" / "measure_quality.py").read_text()
    # the corpus seeds and the staging levers of measure_quality.py's main
    assert 'seed=0, prefix="train"' in src and 'seed=7, prefix="dev"' in src
    assert quality.staging_flags("cache_int8") == ["--feat_dtype", "int8",
                                                   "--device_cache", "True"]
    assert quality.staging_flags("none") == [] and quality.staging_flags("cache") == [
        "--device_cache", "True"]
    with pytest.raises(ValueError):
        quality.staging_flags("int4")


@pytest.mark.parametrize("profile,dtype,staging,name", [
    ("tiny", "float32", "none", "quality_synthetic.json"),
    ("tiny", "bfloat16", "none", "quality_synthetic_bf16.json"),
    ("kernel", "float32", "none", "quality_synthetic_kernel.json"),
    ("kernel", "float32", "cache_int8", "quality_synthetic_kernel_cache_int8.json")])
def test_result_names_and_jax_records(profile, dtype, staging, name):
    """measure_quality.py's file names, under the port's results/; the JAX
    record quoted beside each gate equals the file it names."""
    assert quality.result_name(profile, dtype, staging) == name
    assert Path(quality.default_out(profile, dtype, staging)).parent.name == "results"
    rec = quality.JAX_RECORDS.get((profile, dtype))
    if staging == "none":
        assert rec["file"] == f"benchmarks/{name}"
        jax = json.loads((ROOT / rec["file"]).read_text())
        assert (jax["asr_dev_wer"], jax["st_dev_bleu"], jax["backend"], jax["profile"],
                jax["dtype"]) == (rec["asr_dev_wer"], rec["st_dev_bleu"], rec["backend"],
                                  profile, dtype)
        assert jax["config"] == quality.PROFILES[profile]


@pytest.mark.parametrize("wer,bleu,ok,n_bad", [
    (0.0, 1.0, True, 0), (0.02, 0.98, True, 0), (0.0201, 1.0, False, 1),
    (0.0, 0.9799, False, 1), (0.5, 0.5, False, 2)])
def test_gate_both_sides_of_each_bound(wer, bleu, ok, n_bad):
    passed, bad = quality.gate({"asr_dev_wer": wer, "st_dev_bleu": bleu})
    assert passed == ok and len(bad) == n_bad


def _cfg(cls, dims):
    return cls(acous_dim=dims["las_acous_dim"], acous_hidden_size=dims["las_acous_hidden_size"],
               dim_model=dims["dim_model"], dim_feedforward=dims["dim_feedforward"],
               num_heads=dims["num_heads"], enc_layers=dims["enc_layers"],
               dec_layers=dims["dec_layers"], enc_embedding_size=dims["embedding_size_enc"],
               dec_embedding_size=dims["embedding_size_dec"], mode="ASR_ST")


@pytest.mark.parametrize("profile", ["tiny", "kernel"])
def test_profiles_against_the_fused_las_gates(profile):
    """The kernel profile passes both fused LAS gates, in the port and in
    JAX, and the tiny one neither."""
    dims = quality.PROFILES[profile]
    want = profile == "kernel"
    assert las_flash_supported(_cfg(ModelConfig, dims)) is want
    assert las_tf_flash_supported(_cfg(ModelConfig, dims)) is want
    assert bool(jax_las_flash_supported(_cfg(JaxModelConfig, dims))) is want
    assert bool(jax_las_tf_flash_supported(_cfg(JaxModelConfig, dims))) is want


def _stages(steps, evals, step_k9, eval_k2, dec_k2, k4=1):
    zero = dict.fromkeys(quality.STEP_KERNELS, 0)
    train = lambda: {"steps": steps, "dev_evals": evals,
                     "steps_with": {**zero, "K8 fwd": steps, "K8 bwd": steps,
                                    "K9 fwd": step_k9, "K9 bwd": step_k9},
                     "dev_evals_with": {"K1": evals, "K2": eval_k2, "K3 gather": evals},
                     "launches": {"K2": eval_k2, "K9 fwd": step_k9, "K9 bwd": step_k9}}
    dec = lambda k2, k4_: {"launches": {"K2": k2, "K3": 1, "K4": k4_, "K4 select": k4_,
                                        "K9 fwd": 0, "K9 bwd": 0}}
    return {"asr": train(), "asr_st": train(),
            "emb": {"launches": {"K2": 0, "K9 fwd": dec_k2, "K9 bwd": 0}},
            "dec_asr": dec(dec_k2, 0), "dec_st": dec(dec_k2, k4)}


@pytest.mark.parametrize("profile,stages,n_bad", [
    ("kernel", _stages(24, 2, 24, 2, 3), 0),
    ("kernel", _stages(24, 2, 23, 2, 3), 4),  # a step without K9, both stages
    ("kernel", _stages(24, 2, 24, 1, 3), 2),  # a dev eval without K2
    ("kernel", _stages(24, 2, 24, 2, 0), 3),  # no K2 in the decodes, no K9 in mode 3
    ("tiny", _stages(24, 2, 0, 0, 0), 0),
    ("tiny", _stages(24, 2, 0, 0, 0, k4=0), 1),
    ("tiny", _stages(24, 2, 0, 2, 0), 4)])  # K2 at D 32: dev evals and launches
def test_route_problems_on_recorded_launches(profile, stages, n_bad):
    assert len(quality.route_problems(stages, profile, "cuda")) == n_bad
    assert quality.route_problems(stages, profile, "cpu") == []


def test_short_tiny_run_writes_its_result_and_jax_decodes_it(tmp_path):
    """1 + 1 epochs on 32 + 8 sentences on the CPU: every stage runs, the
    result has every field and is marked short (not judged, exit 0), no
    kernel counted; the JAX CLI's ST beam-5 and ASR decodes of the joint
    checkpoint give the port's dev lines."""
    out = tmp_path / "q.json"
    argv = ["--device", "cpu", "--workdir", str(tmp_path / "w"), "--epochs_asr", "1",
            "--epochs_joint", "1", "--n_train", "32", "--n_dev", "8", "--out", str(out)]
    assert quality.main(argv) == 0
    res = json.loads(out.read_text())
    assert set(res) >= {"corpus", "config", "profile", "dtype", "staging", "epochs", "joint_hp",
                        "asr_dev_wer", "st_dev_bleu", "train_wall_s", "short", "gate", "routes",
                        "stages", "device", "card", "source_sha256"}
    assert res["short"] and res["gate"]["status"] == "not judged (short run)"
    assert res["routes"] == {"status": "pass", "problems": []} and res["card"] is None
    assert res["epochs"] == {"asr": 1, "joint": 1} and res["n_decoded"] == {"asr": 8, "st": 8}
    assert list(res["stages"]) == list(quality.STAGES)
    for name in quality.TRAINING:
        s = res["stages"][name]
        assert s["steps"] == 1 and s["dev_evals"] == 1 and s["loop_steps_per_s"] > 0
        assert not any(s["steps_with"].values()) and not any(s["dev_evals_with"].values())
    assert not any(v for s in res["stages"].values() for v in s["launches"].values())

    work = tmp_path / "w"
    ckpt = next((work / "asr_st" / "checkpoints").iterdir())
    cfg_j, params_j, ck = jax_tr._load_model(str(ckpt))
    ds = JaxDataset(path_src=str(work / "data/dev.src"), path_tgt=str(work / "data/dev.tgt"),
                    vocab_src_list=ck.input_vocab, vocab_tgt_list=ck.output_vocab,
                    use_type="char", acous_path=str(work / "data/dev.flis"), acous_max_len=6000,
                    max_seq_len_src=900, max_seq_len_tgt=900, batch_size=16, mode="ST")
    for gen, beam in (("ST", 5), ("ASR", 1)):
        ref = jax_tr.translate(ds, cfg_j, params_j, str(tmp_path / gen), 24, beam,
                               gen_mode=gen, logger_print=lambda *a: None)
        ours = (work / f"dec_{gen.lower()}" / "translate.txt").read_text(encoding="utf8")
        assert ours.splitlines() == Path(ref).read_text(encoding="utf8").splitlines(), gen
