"""Published device peaks used by the roofline accounting."""

import pytest

from tools.benchmarks import perf_audit


def test_h100_peaks():
    p = perf_audit.peaks_for("NVIDIA H100 80GB HBM3")
    assert p == {"hbm_bytes_per_s": 3.35e12, "bf16_flops": 989e12,
                 "tf32_flops": 495e12, "fp32_flops": 67e12}


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB",
                                  "NVIDIA H100 PCIe", ""])
def test_unknown_device_kind_raises(kind):
    with pytest.raises(ValueError, match="no published peaks"):
        perf_audit.peaks_for(kind)
