"""The port's expectation model (``core.balance``) and lineage gate
(``bench.lineage``, ``bench.cli lineage``) held to the reference package."""
import json
import math
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.bench import lineage as ref_lineage                  # noqa: E402
from repro.core import balance as ref_balance                   # noqa: E402
from repro.core import hardware as ref_hardware                 # noqa: E402
from repro_torch.bench import cli, lineage                      # noqa: E402
from repro_torch.core import balance, hardware                  # noqa: E402

CHIPS = list(hardware.CATALOG)


def _same(a, b):
    """Equal floats, or NaN in both."""
    return (math.isnan(a) and math.isnan(b)) or a == b


def _expectation(mod, old, new, precision):
    e = mod.expect_speedup(old, new, precision)
    return (e.old, e.new, e.precision, e.flop_ratio, e.bw_ratio,
            e.expected, e.binds)


def test_lineage_arc_matches_reference():
    assert hardware.DATACENTER_LINEAGE == ref_hardware.DATACENTER_LINEAGE
    assert hardware.DATACENTER_LINEAGE == (
        "K80", "P100", "V100", "A100", "H100-SXM")


@pytest.mark.parametrize("old_name", CHIPS)
def test_expect_speedup_matches_reference(old_name):
    """Every catalog pair at f32, and at f64 where both chips have f64
    units; f64 with a chip without them (every TPU) raises in both."""
    old, ref_old = hardware.CATALOG[old_name], \
        ref_hardware.CATALOG[old_name]
    for new_name in CHIPS:
        new, ref_new = hardware.CATALOG[new_name], \
            ref_hardware.CATALOG[new_name]
        assert _expectation(balance, old, new, "f32") == \
            _expectation(ref_balance, ref_old, ref_new, "f32")
        assert balance.expected_speedup(old, new) == \
            ref_balance.expected_speedup(ref_old, ref_new)
        if old.has_f64 and new.has_f64:
            assert _expectation(balance, old, new, "f64") == \
                _expectation(ref_balance, ref_old, ref_new, "f64")
        else:
            for mod, a, b in ((balance, old, new),
                              (ref_balance, ref_old, ref_new)):
                with pytest.raises(ValueError, match="no f64 units"):
                    mod.expect_speedup(a, b, "f64")
        for mod, a, b in ((balance, old, new),
                          (ref_balance, ref_old, ref_new)):
            with pytest.raises(ValueError, match="unknown precision"):
                mod.expect_speedup(a, b, "bf16")


@pytest.mark.parametrize("name", CHIPS)
def test_balance_and_roofline_match_reference(name):
    chip, ref_chip = hardware.CATALOG[name], ref_hardware.CATALOG[name]
    got, want = balance.machine_balance(chip), \
        ref_balance.machine_balance(ref_chip)
    assert got.name == want.name
    for field in ("bf_f32", "bf_f64", "density_f32", "density_f64"):
        assert _same(getattr(got, field), getattr(want, field)), field
    rng = np.random.RandomState(sorted(CHIPS).index(name))
    for precision in ("f32", "f64"):
        if precision == "f64" and not chip.has_f64:
            for mod, c in ((balance, chip), (ref_balance, ref_chip)):
                with pytest.raises(ValueError, match="no f64 units"):
                    mod.ridge_point(c, precision)
                with pytest.raises(ValueError, match="no f64 units"):
                    mod.roofline_time(1.0, 1.0, c, precision)
            continue
        assert balance.ridge_point(chip, precision) == \
            ref_balance.ridge_point(ref_chip, precision)
        for flops, nbytes, ai in rng.uniform(0.0, 1e12, size=(4, 3)):
            assert balance.roofline_time(flops, nbytes, chip, precision) == \
                ref_balance.roofline_time(flops, nbytes, ref_chip, precision)
            assert balance.attainable_flops(ai / 1e9, chip, precision) == \
                ref_balance.attainable_flops(ai / 1e9, ref_chip, precision)


def test_lineage_table_matches_reference():
    got, want = balance.lineage_table(), ref_balance.lineage_table()
    assert list(got) == list(want)
    for name in got:
        for field in ("bf_f32", "bf_f64", "density_f32", "density_f64"):
            assert _same(getattr(got[name], field),
                         getattr(want[name], field))


# --- bench.lineage ----------------------------------------------------------

def test_default_reference_is_the_reference_table():
    path = lineage.default_reference_path()
    assert path == ref_lineage.default_reference_path()
    assert path.endswith(os.path.join("experiments", "baselines",
                                      "LINEAGE_hopper.json"))


@pytest.mark.parametrize("precision", ["f32", "f64"])
def test_lineage_doc_matches_reference(precision):
    ref_doc = ref_lineage.to_doc(
        ref_lineage.validate(ref_lineage.load_reference(
            ref_lineage.default_reference_path())),
        ref_lineage.lineage_chain(precision=precision))
    doc = lineage.to_doc(
        lineage.validate(lineage.load_reference(
            lineage.default_reference_path())),
        lineage.lineage_chain(precision=precision))
    assert doc == ref_doc
    assert doc["ok"] and doc["counts"] == {"within-band": 8, "over": 0,
                                           "under": 0}


def test_lineage_chain_on_other_arcs_matches_reference():
    for arc in (["A100", "H100-SXM", "H200"], ["GTX745", "RTX2060S"]):
        assert lineage.to_doc([], lineage.lineage_chain(arc)) == \
            ref_lineage.to_doc([], ref_lineage.lineage_chain(arc))


def test_verdict_bands_match_reference():
    """One pair judged "over", "under" and "within-band" by moving its
    published number around the catalog's expectation."""
    expected = ref_balance.expected_speedup(
        ref_hardware.get_chip("V100"), ref_hardware.get_chip("A100"))
    for published, verdict in ((expected / 1.2, "over"),
                               (expected * 1.2, "under"),
                               (expected * 1.01, "within-band")):
        pair = dict(old="V100", new="A100", published=published, band=0.05)
        got = lineage.validate([lineage.LineagePair(**pair)])
        want = ref_lineage.validate([ref_lineage.LineagePair(**pair)])
        assert [v.verdict for v in got] == [verdict]
        assert lineage.to_doc(got) == ref_lineage.to_doc(want)


@pytest.mark.parametrize("doc,match", [
    ({"kind": "other", "schema": 1, "pairs": []}, "not a lineage-reference"),
    ({"kind": "lineage-reference", "schema": 2, "pairs": []}, "schema"),
    ({"kind": "lineage-reference", "schema": 1, "pairs": []}, "no pairs"),
    ({"kind": "lineage-reference", "schema": 1, "pairs": [
        {"old": "V100", "new": "B200", "published": 2.0, "band": 0.1}]},
     "unknown chip"),
    ({"kind": "lineage-reference", "schema": 1, "pairs": [
        {"old": "V100", "new": "A100", "published": 0.0, "band": 0.1}]},
     "non-positive"),
])
def test_load_reference_rejects_like_reference(tmp_path, doc, match):
    path = tmp_path / "ref.json"
    path.write_text(json.dumps(doc))
    for mod in (lineage, ref_lineage):
        with pytest.raises(ValueError, match=match):
            mod.load_reference(str(path))


def test_cli_lineage(tmp_path, capsys):
    out = tmp_path / "lineage.json"
    assert cli.main(["lineage", "--json", str(out)]) == 0
    text = capsys.readouterr().out
    assert "# lineage: 8 within-band, 0 over, 0 under" in text
    assert "K80 -> P100 -> V100 -> A100 -> H100-SXM" in text
    path = ref_lineage.default_reference_path()
    assert json.loads(out.read_text()) == ref_lineage.to_doc(
        ref_lineage.validate(ref_lineage.load_reference(path)),
        ref_lineage.lineage_chain(), reference=os.path.basename(path))


def test_cli_lineage_exit_codes(tmp_path, capsys):
    assert cli.main(["lineage", "--reference",
                     str(tmp_path / "missing.json")]) == 2
    assert "cannot load reference" in capsys.readouterr().err
    drifted = json.load(open(ref_lineage.default_reference_path()))
    drifted["pairs"][0]["published"] *= 2
    path = tmp_path / "drifted.json"
    path.write_text(json.dumps(drifted))
    assert cli.main(["lineage", "--reference", str(path)]) == 1
    err = capsys.readouterr().err
    assert "drifted outside the published band" in err
