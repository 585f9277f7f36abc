"""The overload-ladder scenario of yadcc_tpu_torch/tools/scenarios.py at
its smoke size on the CPU, on the host greedy policy and on
torch_grouped (K1's plain version: the path the card takes): every SLO
check passes, with the bounds the JAX package's scenario states (a file
of its own so that the suite's workers spread the heavy scenarios)."""

import pytest

from tests.test_torch_scenarios import assert_port_scenario


@pytest.mark.parametrize("policy", ["greedy_cpu", "torch_grouped"])
def test_overload_ladder_passes_in_the_port(policy):
    out = assert_port_scenario("overload-ladder", policy=policy)
    assert out["reached_reject"] == 1 and out["recovered_to_normal"] == 1
