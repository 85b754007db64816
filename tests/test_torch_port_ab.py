"""The port's training as a whole against the JAX package's, the A/B's
statistics, and the card A/B script on the CPU.

scripts/ab_port_vs_jax.py's pairing at the tiny widths of the verify recipe
(D=32, FFN 64, 1 encoder and 2 decoder layers), float32, every dropout rate
0: JAX's Trainer.init_state moved into the port's Trainer, one synthetic
store opened by both packages, both Trainers' `fit` over 2 epochs of 12
steps.  Each of the 24 steps' losses agrees within rtol 1e-5 (float32
rounding in other summation orders; the runs diverge no faster at these
widths, the two packages agree to 1e-6 over 40 steps).  The histories:
the training losses within rtol 1e-5, the steps equal, the evaluation
metrics within rtol 1e-5 (the same rows ranked and localized from weights
that agree to float32 rounding).  JAX's kernels run in interpret mode, the
port's wrappers their plain versions.

scripts/ab_stats.py: the paired and Welch comparisons and Holm's step-down
against hand-computed values, one seed refused, the report's seed count
from its records, the spread test.  scripts/ab_kernels_cuda.py: a
`--device cpu` run of every mode at tiny widths.
"""

import os
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import ab_kernels_cuda  # noqa: E402
import ab_port_vs_jax  # noqa: E402
import ab_stats  # noqa: E402
from mgsv_tpu_torch.data import synthetic  # noqa: E402

TINY = {"data.max_v_frames": 12, "data.stride": 20.0, "data.filter_sec": 20.0,
        "data.vit_dim": 64, "data.ast_dim": 96, "model.dim_input": 32,
        "model.temporal_mlp_dim": 64, "model.detr_ffn_dim": 64, "model.detr_enc_layers": 1,
        "model.detr_dec_layers": 2, "model.contrastive_dim": 32, "model.video_pe_len": 40,
        "model.audio_pe_len": 40, "model.compute_dtype": "float32"}
TINY_ARGS = [s for k, v in TINY.items() for s in (f"--{k}", str(v))]
ROWS, BATCH, EPOCHS = 96, 8, 2          # 12 steps an epoch, 24 in all
RTOL = 1e-5


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """Both Trainers' fit from JAX's init, with each step's loss recorded."""
    tmp = str(tmp_path_factory.mktemp("ab"))
    over = {**TINY, **ab_port_vs_jax.NO_DROPOUT, "train.batch_size_train": BATCH,
            "train.batch_size_val": BATCH, "train.epochs": EPOCHS,
            "train.save_checkpoints": False, "train.seed": 42}
    cfg, jcfg = ab_port_vs_jax.configs(over)
    root = os.path.join(tmp, "data")
    synthetic.generate(root, n_rows=ROWS, n_unique_music=ROWS // 2, data_cfg=cfg.data, seed=0)
    jt, pt = ab_port_vs_jax.paired_trainers(cfg, jcfg, root, tmp, jax_device=jax.devices()[0])
    jax_losses, port_losses = ab_port_vs_jax.record_steps(jt, pt)
    return jt.fit(), pt.fit(), jax_losses, port_losses


def test_trainer_steps_match_jax(fits):
    """Each of the 24 steps' losses, through both Trainers' steps over both
    packages' epoch_batches, within rtol 1e-5."""
    _, _, jax_losses, port_losses = fits
    assert len(jax_losses) == len(port_losses) == ROWS // BATCH * EPOCHS
    gaps = ab_port_vs_jax.step_gaps(jax_losses, port_losses)
    assert (gaps <= RTOL).all(), gaps


def test_trainer_fit_histories_match_jax(fits):
    """Each epoch's record: the training statistics and every evaluation
    metric within rtol 1e-5 (atol 1e-6 for values near zero)."""
    jax_fit, port_fit, _, _ = fits
    assert [r["epoch"] for r in jax_fit["history"]] == [r["epoch"] for r in
                                                        port_fit["history"]] == [1, 2]
    for jr, pr in zip(jax_fit["history"], port_fit["history"]):
        assert jr["train"]["steps"] == pr["train"]["steps"] == ROWS // BATCH
        for key in ("loss", "retrieval_loss", "localization_loss", "miou"):
            np.testing.assert_allclose(pr["train"][key], jr["train"][key], rtol=RTOL,
                                       err_msg=f"epoch {jr['epoch']} {key}")
        assert pr["eval"].keys() == jr["eval"].keys()
        for key, want in jr["eval"].items():
            np.testing.assert_allclose(pr["eval"][key], want, rtol=RTOL, atol=1e-6,
                                       err_msg=f"epoch {jr['epoch']} {key}")
    assert port_fit["best"].keys() == jax_fit["best"].keys()


def _records(a, b, a_name="ref", b_name="our"):
    return [{"seed": i, **{f"{a_name}_{k}": x for k in ab_stats.METRICS},
             **{f"{b_name}_{k}": y for k in ab_stats.METRICS}} for i, (x, y) in enumerate(zip(a, b))]


def test_paired_and_welch_against_hand_values():
    """a = [1, 2, 3, 4], b = [2, 2, 4, 6]: differences [1, 0, 1, 2], mean 1,
    sd sqrt(2/3), paired t = 1 / (sqrt(2/3) / 2) = 2.449490 on 3 df; Welch
    SE sqrt(5/3 / 4 + 11/3 / 4) = 1.154701, t = 0.866025 on
    (4/3)^2 / ((5/12)^2 / 3 + (11/12)^2 / 3) = 5.260274 df."""
    from scipy import stats as sps

    stats = ab_stats.compare_seeds(_records([1, 2, 3, 4], [2, 2, 4, 6]), rows=100,
                                   keys=("R1",))["R1"]
    assert stats["gap"] == 1.0 and stats["diff_mean"] == 1.0
    np.testing.assert_allclose(stats["paired_se"], np.sqrt(2 / 3) / 2, rtol=1e-12)
    np.testing.assert_allclose(stats["p_paired"], 2 * sps.t.sf(2.449489742783178, 3),
                               rtol=1e-9)
    np.testing.assert_allclose(stats["p_paired"], sps.ttest_rel([2, 2, 4, 6], [1, 2, 3, 4]).pvalue,
                               rtol=1e-9)
    np.testing.assert_allclose(stats["paired_ci95_halfwidth"],
                               sps.t.ppf(0.975, 3) * np.sqrt(2 / 3) / 2, rtol=1e-12)
    np.testing.assert_allclose(stats["welch_se"], 1.1547005383792515, rtol=1e-12)
    np.testing.assert_allclose(stats["welch_df"], 5.260273972602739, rtol=1e-9)
    np.testing.assert_allclose(stats["p_welch"], 2 * sps.t.sf(0.8660254037844386,
                                                              5.260273972602739), rtol=1e-9)
    np.testing.assert_allclose(
        stats["p_welch"], sps.ttest_ind([2, 2, 4, 6], [1, 2, 3, 4], equal_var=False).pvalue,
        rtol=1e-9)
    assert stats["resolution"] == 1.0          # 100 / 100 rows, one evaluation
    assert stats["mde"] == max(stats["paired_ci95_halfwidth"], 1.0)
    assert stats["compatible"] == (1.0 <= stats["mde"])


def test_holm_step_down():
    """Sorted p 0.01, 0.03, 0.04 against 0.05/3, 0.05/2, 0.05: the first
    rejects, the second does not, so neither does the third; with 0.02 in
    the middle all three reject.  A rejection also needs a gap above the
    resolution."""
    assert ab_stats.holm({"a": 0.01, "b": 0.04, "c": 0.03}) == {"a": True, "b": False,
                                                               "c": False}
    assert ab_stats.holm({"a": 0.01, "b": 0.04, "c": 0.02}) == {"a": True, "b": True,
                                                               "c": True}
    rng = np.random.default_rng(0)
    ref = rng.normal(50, 1, 12)
    stats = ab_stats.compare_seeds(_records(ref, ref + 3), rows=768)
    assert all(s["holm_reject"] for s in stats.values())
    assert not ab_stats.family_clean(stats)
    tiny = ab_stats.compare_seeds(_records(ref, ref + 1e-4), rows=768)
    assert all(s["p_paired"] < 1e-6 and not s["holm_reject"] for s in tiny.values())


def test_one_seed_raises():
    with pytest.raises(ValueError, match="at least 2"):
        ab_stats.compare_seeds(_records([1.0], [2.0]), rows=100)
    with pytest.raises(ValueError, match="at least 2"):
        ab_stats.compare_draws([1.0], [1.0, 2.0])


def test_report_header_counts_the_records():
    """Both scripts' headers give the number of records they were given,
    whatever a run was asked for."""
    rng = np.random.default_rng(1)
    setup = {"rows": 768, "epochs": 10, "bs": 32, "family_size": 32, "family_delta": 0.15,
             "eval_last_k": 4, "overrides": {}}
    recs = [{**r, "setup": setup, "seconds": {"jax": 1.0, "port": 1.0}}
            for r in _records(rng.normal(70, 4, 3), rng.normal(70, 4, 3), "jax", "port")]
    lines = ab_port_vs_jax.paper_section(recs)
    assert "over 3 paired seeds (0, 1, 2)" in lines[0]
    a = ab_kernels_cuda.parse_args(["--dropout", "paper", "--ab-seeds", "24"])
    krecs = [{"seed": i, "launches": {arm: {} for arm in ab_kernels_cuda.ARMS},
              "seconds": {arm: 1.0 for arm in ab_kernels_cuda.ARMS},
              **{f"{arm}_{k}": float(rng.normal(70, 4)) for arm in ab_kernels_cuda.ARMS
                 for k in ab_stats.METRICS}} for i in range(5)]
    lines = ab_kernels_cuda.paper_section(krecs, "card", a)
    assert "--ab-seeds 5 " in lines[0] and "over 5 paired seeds" in lines[0]


def test_spread_test_flags_doubled_variance():
    """300 draws: the same draws scaled by sqrt(2) about their mean (twice
    the variance, the same mean) fail the spread test and not the mean
    test; the same draws reordered pass both."""
    draws = np.random.default_rng(2).normal(5.0, 0.3, 300)
    doubled = draws.mean() + np.sqrt(2.0) * (draws - draws.mean())
    r = ab_stats.compare_draws(draws, doubled)
    np.testing.assert_allclose(r["f_ratio"], 2.0, rtol=1e-12)
    assert r["p_spread"] < 1e-4 and r["p_f"] < 1e-4 and r["p_mean"] > 0.99
    assert ab_stats.holm({"spread": r["p_spread"], "mean": r["p_mean"]})["spread"]
    same = ab_stats.compare_draws(draws, draws[::-1])
    assert same["p_spread"] == pytest.approx(1.0) and same["p_mean"] == pytest.approx(1.0)
    assert not any(ab_stats.holm({"spread": same["p_spread"], "mean": same["p_mean"]}).values())


def test_ab_kernels_script_on_the_cpu(tmp_path):
    """Every mode of scripts/ab_kernels_cuda.py with --device cpu at tiny
    widths: it passes its checks (on the CPU the kernel wrappers run their
    plain versions and launch nothing) and writes its report's sections;
    --stats-from rewrites the paired-seed section from its records alone."""
    report = str(tmp_path / "report.md")
    common = ["--device", "cpu", "--rows", "32", "--bs", "8", "--epochs", "2",
              "--report", report, "--out", str(tmp_path)] + TINY_ARGS
    assert ab_kernels_cuda.main(common + ["--dropout", "off", "--steps", "4", "--fingerprint",
                                          "--draws", "6", "--fp-rows", "8"]) == 0
    assert ab_kernels_cuda.main(common + ["--dropout", "paper", "--ab-seeds", "2",
                                          "--eval-last-k", "1"]) == 0
    text = open(report).read()
    for heading in ("dropout off", "dropout fingerprint", "dropout on, paired seeds"):
        assert text.count(f"## Kernel path against plain path: {heading}") == 1, heading
    assert "Verdict: **held**" in text and "over 2 paired seeds" in text
    again = str(tmp_path / "again.md")
    assert ab_kernels_cuda.main(["--stats-from", str(tmp_path / "ab_kernels_paper.jsonl"),
                                 "--report", again]) == 0
    section = text[text.index("## Kernel path against plain path: dropout on"):]
    assert open(again).read().split("\n", 2)[2].strip() == section.strip()
