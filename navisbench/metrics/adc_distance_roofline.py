"""``adc_distance``'s share of its roofline in the traced part of the
window, in %: the bytes its launches must move (each lane's LUT, its
codes and its distances, once: ``tracing.adc_bytes`` of the shapes each
launch was given) at the H100's 3.35 TB/s, over the profiler's device
time of the kernel.  The kernel is bound by bytes: it does one add per
byte of codes."""
from navisbench.tracing import PEAK_BYTES_S


def read(rec):
    t = rec.trace
    if not t or not t["adc_bytes"]:
        return None
    dev_s = t["kernels"].get("adc_distance_kernel", [0.0])[0]
    if not dev_s:
        return None
    return 100.0 * t["adc_bytes"] / PEAK_BYTES_S / dev_s
