"""The control of `correct` on the card: the port with TF32 allowed inside
its entry points (whose precision scope turns it off: the configuration
states float32) comes out not correct, and the port as it is comes out
correct, on one job over the static circuit's first two segments (73
frames at 640x480). `control.py` reads the same at the cells' own sizes."""

import pytest

from slambench import check, control, spec


def _small_static():
    cell = spec.load_cell(spec.benchmark(), "static_loop.offline")
    conf = dict(cell["config"], offline=dict(cell["config"]["offline"], job_frames=73))
    return dict(cell, config=conf)


@pytest.mark.card
@pytest.mark.parametrize("ctl", ["none", "tf32"])
def test_control_fails_and_the_port_passes(cuda_device, ctl):
    cell = _small_static()
    got = control.readings(cell, 2**31 + 7, ctl, 0, cuda_device)
    ok, rows = check.decide({k: got[k] for k in cell["limits"]}, cell["limits"], 73,
                            got["failed"])
    assert ok == (ctl == "none"), rows
