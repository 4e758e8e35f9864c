"""bench.py and chip_smoke.py measure the GPU only: with no GPU they fail
instead of falling back to the CPU."""

import pytest

import bench
import chip_smoke


@pytest.mark.parametrize("entry", [bench.main, lambda: chip_smoke.main([])])
def test_refuses_to_run_without_gpu(entry, capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        entry()
    assert '"ok"' not in capsys.readouterr().out
