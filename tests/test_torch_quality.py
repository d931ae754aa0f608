"""The whole-run regret check at c=24 on the CPU.

Torch's streams cannot reproduce JAX's, so the port's sampling is held
over whole runs: ``scripts/quality_study_torch.py``'s 60-trial TPE runs
(seeds 0-3) on each ``QUALITY.md`` domain, whose mean regret may not lie
above the reference's worst seed in ``QUALITY.json``
(``device/<domain>/c24``).  The larger candidate counts run on the card
(``chip_smoke.py``'s ``quality`` phase)."""

import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "quality_study_torch", os.path.join(REPO, "scripts", "quality_study_torch.py"))
QS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(QS)


def test_check_row_holds_the_mean_to_the_worst_reference_seed():
    ref = {"device/d/c24": {"per_seed": [1.0, 3.0, 2.0], "mean_regret": 2.0}}
    assert QS.check_row("device/d/c24", [2.0, 4.0], ref)["ok"]  # mean 3.0 == worst
    row = QS.check_row("device/d/c24", [3.0, 3.2], ref)
    assert not row["ok"] and row["reference_worst"] == 3.0 and row["mean_regret"] == 3.1


@pytest.mark.parametrize("dname", QS.DOMAINS)
def test_regret_at_c24_within_the_reference_seed_spread(dname):
    (row,) = QS.study(cands=(24,), domains=(dname,), device="cpu")
    assert len(row["per_seed"]) == len(QS.SEEDS)
    assert row["ok"], (
        f"{row['key']}: mean regret {row['mean_regret']:.6g} (seeds {row['per_seed']}) "
        f"above the reference's worst seed {row['reference_worst']:.6g} "
        f"(seeds {row['reference_per_seed']})")
