"""The burst scenario of yadcc_tpu_torch/tools/scenarios.py at its smoke
size on the CPU: every SLO check passes, with the bounds the JAX
package's scenario states (a file of its own so that the suite's
workers spread the heavy scenarios; tests/test_torch_scenarios.py holds
the rest of the matrix)."""

from tests.test_torch_scenarios import assert_port_scenario


def test_burst_passes_in_the_port():
    assert_port_scenario("burst")
