"""``repro_torch.analysis.astlint``: the port's source rules, each on a
seeded source (the reference's ``tests/test_analysis.py`` AST cases, in
the port's terms), and ``src/repro_torch/`` clean under all of them."""
import os

import pytest

from repro_torch.analysis import astlint
from repro_torch.analysis.astlint import lint_path, lint_source

ROUND = ("def device_round(self, state, data, generator):\n"
         "    {line}\n"
         "    return state, {{}}\n")

# (what a round body does, the import it needs)
HOST_CALLS = {
    "np_random": ("x = np.random.rand()", "import numpy as np\n"),
    "time": ("t = time.perf_counter()", "import time\n"),
    "datetime": ("t = datetime.datetime.now()", "import datetime\n"),
    "item": ("v = state.t.item()", ""),
    "tolist": ("v = state.t.tolist()", ""),
    "cpu": ("v = state.server.cpu()", ""),
    "print": ("print(state)", ""),
}


def _rules(viols):
    return [v.rule for v in viols]


@pytest.mark.parametrize("call", sorted(HOST_CALLS))
def test_r001_host_call_in_a_round_body(call):
    line, imp = HOST_CALLS[call]
    src = imp + ROUND.format(line=line)
    assert _rules(lint_source(src, "core/x.py")) == [
        "R001:host-call-in-round"]
    # in a function defined inside the round: still the round's body
    nested = imp + ROUND.format(line=f"def f():\n        {line}")
    assert _rules(lint_source(nested, "core/x.py")) == [
        "R001:host-call-in-round"]
    # outside a round body (set-up, the adaptive walk's scan_rounds): fine
    outside = imp + (f"def scan_rounds(self, state, data, g, n):\n"
                     f"    {line}\n    return state\n")
    assert lint_source(outside, "core/x.py") == []


def test_r002_unresolved_spec():
    src = "cfg = FedConfig(n_clients=4, codec_up='no_such_codec:bits=8')\n"
    assert _rules(lint_source(src, "x.py")) == ["R002:unresolved-spec"]
    ok = ("cfg = FedConfig(codec_up='lattice:bits=8', "
          "participation='cyclic:period=8')\n"
          "alg = mk(uplink={'fast': 'lattice', "
          "'slow': 'lattice_packed:bits=4'})\n")
    assert lint_source(ok, "x.py") == []
    bad = ("alg = mk(uplink={'fast': 'lattice', 'slow': 'latice'}, "
           "participation='no_such_spec')\n")
    assert _rules(lint_source(bad, "x.py")) == ["R002:unresolved-spec"] * 2


def test_r003_metrics_schema():
    src = ("def device_round(self, state, data, generator):\n"
           "    metrics = {'sim_time': 0.0}\n"
           "    return state, metrics\n")
    v = lint_source(src, "fed/x.py")
    assert _rules(v) == ["R003:metrics-schema"] and "bits_up" in v[0].detail
    full = src.replace("{'sim_time': 0.0}", "{'sim_time': 0.0, "
                       "'round_time': 0.0, 'bits_up': 0.0, 'bits_down': 0.0,"
                       " 'h_steps_mean': 0.0, 'quant_err': 0.0}")
    assert lint_source(full, "fed/x.py") == []


def test_r004_unused_import():
    v = lint_source("import os\nimport sys\nprint(sys.argv)\n", "x.py")
    assert _rules(v) == ["R004:unused-import"] and "os" in v[0].detail
    assert lint_source("import os  # noqa: F401\n", "x.py") == []
    assert lint_source("import os\n__all__ = ['os']\n", "x.py") == []
    assert lint_source("import os\n", "pkg/__init__.py") == []


def test_port_source_is_clean():
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        astlint.__file__)))
    assert root.endswith("repro_torch")
    viols = lint_path(root)
    assert viols == [], [v.as_dict() for v in viols]
