"""The digest of the ResNet-50 sweep that phase 9 of chip_smoke.py runs on
the card: the JAX package's numpy-backend report of one design point
(ResNet-50, log block 4, memory width 8, scratchpad scale 1, ``--tune
full``), and chip_smoke.py pinning the same digest. Tolerance 0: the report
by sha256 of its text as the backends are compared. In a file of its own,
so that the sweep (~80 s on the CPU) runs on one test worker."""
import hashlib
import os
import re

from test_torch_dse import _report_text

# sha256 of the JAX package's numpy-backend report.json (without wall_s,
# cache and profile; JSON with sorted keys) on phase 9's ResNet-50 point
DSE50_DIGEST = \
    "d91ded6e38854d7137cac5cf7a3b2d87bd94d819df80d93b7df1b4b68bcbf006"
DSE50_GRID = dict(log_blocks=(4,), mem_widths=(8,), spad_scales=(1,),
                  tune="full", workers=1)


def test_resnet50_point_digest_of_the_jax_package(tmp_path):
    from repro.core import dse as jdse
    jdse.run_sweep(["resnet50"], out_dir=str(tmp_path), backend="numpy",
                   **DSE50_GRID)
    text = _report_text(tmp_path / "report.json")
    assert hashlib.sha256(text.encode()).hexdigest() == DSE50_DIGEST


def test_chip_smoke_pins_the_same_resnet50_digest():
    path = os.path.join(os.path.dirname(__file__), os.pardir,
                        "chip_smoke.py")
    with open(path) as f:
        text = f.read()
    m = re.search(r'DSE50_DIGEST = \\\s*"([0-9a-f]{64})"', text)
    assert m and m.group(1) == DSE50_DIGEST
