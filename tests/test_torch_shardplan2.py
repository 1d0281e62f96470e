"""The second half of test_torch_shardplan.py's cases (`ARCHS2`): phi3's
and the SSM, vision, encoder-decoder and MoE architectures' quick
dry-run cells against the reference's, within the same bounds."""
from __future__ import annotations

import pytest

from test_torch_shardplan import ARCHS2, check_arch


@pytest.mark.parametrize("arch", ARCHS2)
def test_sharded_step_within_bounds_of_reference(arch, tmp_path):
    check_arch(arch, tmp_path)
