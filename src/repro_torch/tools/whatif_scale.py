"""Scale what-if: project a training cell's DCN gradient traffic and
compute to fleets of many pods.

Counterpart of the reference's ``tools/whatif_scale.py``, on the port's
hardware model (``core/hardware.py``: a pod is one H100, the DCN is
InfiniBand at the data sheet's rate) and ``core/datapath.wire_bytes``:
weak scaling on the pod axis (the global batch grows with the pods), the
ring all-reduce of the gradients over ``pod``, the same with int8
gradients (a quarter of the bytes), a pipeline over pods that ships the
boundary activations instead, and the compute of one pod's batch share
of ``train_4k``.  Analysis only: it allocates nothing and needs no card.

    python -m repro_torch.tools.whatif_scale --arch gemma3-27b
"""

from __future__ import annotations

import argparse

from repro_torch.configs import SHAPES, get_config
from repro_torch.core.datapath import wire_bytes
from repro_torch.core.hardware import get_active_system
from repro_torch.models.model_zoo import ModelBundle

#: the fleet sizes of the table
PODS = (2, 4, 8, 16, 32, 64)


def table(arch: str, grad_bytes_per_param: float = 2.0, system=None) -> list[dict]:
    """One row per fleet size of :data:`PODS`: ``pods``, ``chips``, the
    seconds of the DCN gradient all-reduce (``t_dcn``), with int8
    (``t_dcn_q``), of a pipeline's boundary activations (``t_pipe``), one
    pod's compute (``t_compute``), and the ``verdict``."""
    cfg = get_config(arch)
    shape = SHAPES["train_4k"]
    system = system or get_active_system()
    chip, pod_chips = system.chip, system.pod.num_chips
    grad_bytes = cfg.num_params() * grad_bytes_per_param
    t_compute = ModelBundle(cfg).model_flops(shape) / pod_chips / chip.peak_bf16_flops
    # bf16 boundary activations per pod hop per step
    act_bytes = 2.0 * shape.global_batch * shape.seq_len * cfg.d_model
    out = []
    for pods in PODS:
        t_dcn = wire_bytes("all-reduce", grad_bytes / pod_chips, pods) / chip.dcn_bandwidth
        t_dcn_q = t_dcn / 4.0
        t_pipe = act_bytes / pod_chips / chip.dcn_bandwidth
        verdict = ("compute-bound" if t_compute > max(t_dcn_q, t_pipe)
                   else "compression sufficient" if t_dcn_q < t_compute
                   else "pipeline the pod axis")
        out.append(dict(pods=pods, chips=pods * pod_chips, t_dcn=t_dcn, t_dcn_q=t_dcn_q,
                        t_pipe=t_pipe, t_compute=t_compute, verdict=verdict))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-27b")
    ap.add_argument("--grad-bytes-per-param", type=float, default=2.0)
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    print(f"{cfg.name}: {cfg.num_params() / 1e9:.1f}B params, weak scaling on the pod "
          f"axis (per-pod batch {SHAPES['train_4k'].global_batch})\n")
    print(f"{'pods':>5s} {'chips':>7s} {'DCN grad AR (s)':>16s} {'w/ int8 (s)':>12s} "
          f"{'pipeline (s)':>13s} {'compute/pod (s)':>16s} {'verdict':>24s}")
    for r in table(args.arch, args.grad_bytes_per_param):
        print(f"{r['pods']:5d} {r['chips']:7d} {r['t_dcn']:16.3f} {r['t_dcn_q']:12.3f} "
              f"{r['t_pipe']:13.3f} {r['t_compute']:16.3f} {r['verdict']:>24s}")
    print("\nInterpretation: the DCN gradient all-reduce approaches "
          "2*grad_bytes/(pod_chips*dcn_bw) as pods grow (the ring factor saturates); "
          "int8 compression buys 4x, and pipelining swaps gradient bytes for "
          "microbatch activations.")


if __name__ == "__main__":
    main()
