"""The GN kernel's (`gn_kernel`, K1 / K1b) share in % of its roofline over
the traced slice: the least time of the GN work that the slice's tracked
calls need (each level's configured iterations at its pixel count, the
coarsest level's over its starts; bytes read and written once and float32
operations, by the benchmark's frozen count against the frozen peaks of
the card named), over the device time of the `gn_kernel` launches in the
trace. The work comes from the traffic and the configuration, not from the
launches."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "portbench_roofline", Path(__file__).resolve().parents[1] / "reference" / "roofline.py")
_roof = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_roof)


def read(record):
    t = record["trace"]
    if not t:
        return None
    kernel_s = sum(v for k, v in t["kernel_s"].items() if "gn_kernel" in k)
    tracked = sum(1 for c in record["calls"] if c["traced"] and c["kind"] == "tracked")
    cam = record["config"]["camera"]
    need = _roof.tracked_frame_gn_s(record["config"]["icp"], cam["height"], cam["width"],
                                    record["streams"], record["card"])
    if kernel_s <= 0 or tracked == 0 or need is None:
        return None
    return 100.0 * tracked * need / kernel_s
