"""Reference-in-the-loop parity for ``orphics.interfaces`` —
``CAMBInterface``'s ini rewriting and scalCovCls parsing (reference
``interfaces.py:323-423``). No CAMB binary is needed: the parity is on
the rewritten ini bytes and the output-table parsing."""
import os
import sys

import numpy as np
import pytest

REF_ROOT = "/root/reference"
SHIM = os.path.join(os.path.dirname(__file__), "_ref_shims")

pytestmark = pytest.mark.skipif(
    not os.path.isdir(os.path.join(REF_ROOT, "orphics")),
    reason="upstream reference not mounted")

for p in (SHIM, REF_ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

rint = pytest.importorskip("orphics.interfaces")

from orphics_tpu import interfaces as tint  # noqa: E402

TEMPLATE = """# CAMB Sources base ini
output_root = test
get_scalar_cls = T
ombh2 = 0.0226
omch2=0.112
  hubble   =  70
l_max_scalar = 2000
num_redshiftwindows = 2
#output_root = commented_out
DEFAULT(batch2/common.ini)
"""

EDITS = [
    ("ombh2", "0.0224"),              # existing, spaced
    ("omch2", 0.119),                 # existing, unspaced, non-str value
    ("hubble", "67.3"),               # existing, odd whitespace
    ("l_max_scalar", 4000),           # existing
    ("num_redshiftwindows", "3"),     # existing
    ("redshift(3)", "2"),             # missing -> append (blank line)
    ("redshift_kind(3)", "lensing"),  # missing -> append
    ("transfer_redshift(1)", "0.5"),  # missing -> transfer quirk
    ("redshift(3)", "2.5"),           # re-edit an appended key
]


def _drive(cls, tmpdir):
    os.makedirs(str(tmpdir), exist_ok=True)
    tdir = str(tmpdir)
    tpl = os.path.join(tdir, "params.ini")
    with open(tpl, "w") as f:
        f.write(TEMPLATE)
    ci = cls(tpl, tdir)
    for k, v in EDITS:
        ci.set_param(k, v)
    with open(ci.ifile) as f:
        text = f.read()
    return ci, text


def test_camb_interface_ini_rewrite_matches_reference(tmp_path):
    rci, rtext = _drive(rint.CAMBInterface, tmp_path / "ref")
    tci, ttext = _drive(tint.CAMBInterface, tmp_path / "ours")
    assert ttext == rtext
    # the working copy is named off the template with the uid suffix
    assert os.path.basename(tci.ifile) == os.path.basename(rci.ifile)
    assert tci.out_name == rci.out_name
    # the rewritten ini really carries the edits, reference-style
    assert "ombh2=0.0224\n" in ttext
    assert "hubble=67.3\n" in ttext
    assert "#output_root = commented_out" in ttext  # comments untouched
    del rci, tci


def test_camb_interface_get_cls_matches_reference(tmp_path):
    rng = np.random.default_rng(3)
    ells = np.arange(2, 52)
    ncomp = 5  # T, E, phi + 2 windows
    table = np.column_stack(
        [ells] + [rng.standard_normal(ells.size) for _ in range(ncomp ** 2)])
    for sub in ("ref", "ours"):
        d = tmp_path / sub
        d.mkdir(exist_ok=True)
        with open(d / "params.ini", "w") as f:
            f.write(TEMPLATE)
    rci = rint.CAMBInterface(str(tmp_path / "ref" / "params.ini"),
                             str(tmp_path / "ref"))
    tci = tint.CAMBInterface(str(tmp_path / "ours" / "params.ini"),
                             str(tmp_path / "ours"))
    for sub, ci in (("ref", rci), ("ours", tci)):
        np.savetxt(str(tmp_path / sub / (ci.out_name + "_scalCovCls.dat")),
                   table)
    rells, rcls = rci.get_cls()
    tells, tcls = tci.get_cls()
    np.testing.assert_array_equal(tells, rells)
    assert tcls.shape == rcls.shape == (ncomp, ncomp, ells.size)
    np.testing.assert_allclose(tcls, rcls, rtol=1e-12)
    del rci, tci
