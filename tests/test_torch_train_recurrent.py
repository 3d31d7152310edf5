"""One train step of the recurrent families against the reference's, on
the CPU: ssm (RWKV6) and hybrid (Zamba2, S = 256 for the SSD chunks), held
as ``test_torch_train_families.py`` holds the others."""
import pytest
import torch

from test_torch_train_families import check_train_step


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("arch", ["rwkv6_3b", "zamba2_7b"])
def test_train_step_equals_the_reference(arch):
    check_train_step(arch)
