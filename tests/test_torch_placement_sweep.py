"""The port's placement sweep example against the reference's, on the CPU.

``python -m repro_torch.examples.placement_sweep --analytic`` prints the
planner's train and decode tables for every registered policy and for the
RESIDENT host spellings (``kv=host``, ``params=host``, ``opt=host``).  Fed
the reference's spec-sheet values (``port_system``), each row for olmo-1b
equals the reference example's (``examples/placement_sweep.py
--analytic``) for the same policy, and each RESIDENT row the reference
planner's price of the same spelling; the full example (its measured
part on the CPU's smoke config) runs.
"""

import contextlib
import functools
import importlib.util
import io
import os

import jax
import pytest

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.core import placement as rP
from repro.core import planner as rPl
from repro.models.model_zoo import ModelBundle as RefBundle
from repro_torch.core.hardware import get_active_system, set_active_system
from repro_torch.core.placement import registered_policies
from repro_torch.examples import placement_sweep

from test_torch_datapath import PORT

jax.config.update("jax_platform_name", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ("olmo-1b", 256, 16, 2)          # the reference example's defaults


def _rows(text: str) -> dict[str, list[str]]:
    """Policy name -> its table rows (train, then decode), the pick's mark
    and the spec-sheet note cut (the port runs on a system other than its
    own spec sheet here, so it adds one)."""
    out = {}
    for line in text.splitlines():
        if line.startswith("  ") and ": step=" in line:
            row = line.strip().replace(" <== planner pick", "").split(" [spec: ")[0]
            out.setdefault(row.split(":")[0], []).append(row)
    return out


@functools.lru_cache(maxsize=None)
def _reference_rows() -> dict[str, list[str]]:
    spec = importlib.util.spec_from_file_location(
        "reference_placement_sweep", os.path.join(ROOT, "examples", "placement_sweep.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref.predicted_tables(*ARGS)
    rows = _rows(buf.getvalue())
    # the RESIDENT spellings: the reference planner's price of each
    bundle = RefBundle(ref_get_config(ARGS[0]))
    profs = (bundle.train_workload(REF_SHAPES["train_4k"], num_chips=ARGS[1],
                                   data_axis_size=ARGS[2], pod_axis_size=ARGS[3]),
             bundle.decode_workload(REF_SHAPES["decode_32k"], num_chips=ARGS[1]))
    for s in placement_sweep.RESIDENT_SPELLINGS:
        pol = rP.parse_policy(s).renamed(s)
        rows[s] = [rPl.predict(prof, pol).explain() for prof in profs]
    return rows


@functools.lru_cache(maxsize=None)
def _port_rows() -> dict[str, list[str]]:
    before = get_active_system()
    set_active_system(PORT)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            placement_sweep.predicted_tables(*ARGS)
    finally:
        set_active_system(before)
    return _rows(buf.getvalue())


@pytest.mark.parametrize("policy", list(registered_policies())
                         + list(placement_sweep.RESIDENT_SPELLINGS))
def test_predicted_rows_equal_the_reference_examples(policy):
    got, want = _port_rows()[policy], _reference_rows()[policy]
    assert len(got) == 2 and got == want


def test_the_example_runs_on_the_cpu(capsys):
    placement_sweep.main(["--arch", "olmo-1b", "--device", "cpu", "--iters", "2"])
    out = capsys.readouterr().out
    rows = {line.split()[0] for line in out.split("predicted vs measured")[1].splitlines()
            if line.strip()}
    # every policy one device realizes is measured; peer and remote starred
    assert {"kv_peer_hbm*", "weights_peer_hbm*", "opt_peer_host*", "kv_remote_hbm*"} <= rows
    assert {"hbm_resident", "opt_host", "kv_host", "weights_stream",
            *placement_sweep.RESIDENT_SPELLINGS} <= rows
    placement_sweep.main(["--analytic"])
    assert "predicted vs measured" not in capsys.readouterr().out
