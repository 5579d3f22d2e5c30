"""The ring MAC (``csrc/ring_mac.cu``: K7, K15 and K8's state kernel) built in
other layouts, side by side.

    python3 tools/ring_mac_layouts.py [--only NAME,...]

For each entry of ``LAYOUTS`` (text replacements of ``ring_mac.cu``'s
constants: rows of V a row item carries, shared-memory stages, the blocks an
SM that ``__launch_bounds__`` asks registers for) it builds ``ring_mac.cu``
alone in a copy of ``csrc/`` under ``build/ring_mac_layouts/NAME/``
(``tools/layouts.py``). Then, on one card in one
process, at 128 channels, it prints ptxas's registers of each
instantiation and, at each of ``SHAPES`` (the paths' K7, K15 and K8 state
kernel shapes), the device ms of the launch (``torch.profiler``, mean of
10) and the SNR against the plain version. Every entry computes the same
function; ``shipped`` is the source as it is.

Needs one CUDA card and nvcc; imports nothing of JAX. Exits non-zero
without a card.
"""

import re
import sys
from pathlib import Path

import torch

from layouts import build, card, device_ms, ptxas, snr, variant_names

from hisstools_library_tpu_torch.fft import hopper_fft, hopper_kernels  # noqa: E402

SRC = "ring_mac.cu"
CONSTANTS = ("kRows", "kStages", "kMinBlocks")
# name: {constant: value} in place of ring_mac.cu's ({}: as shipped).
LAYOUTS = {
    "shipped": {},
    "rows1": {"kRows": 1},                        # one V row a row item
    "stages11": {"kStages": 11},                  # 45 KB of stages (static limit 48 KB)
    "blocks3": {"kMinBlocks": 3},                 # registers for 3 blocks an SM
    "rows1-blocks3": {"kRows": 1, "kMinBlocks": 3},
}
# (label, kernel, C, T, P, K, lead_skip or lag0)
SHAPES = [
    ("K8 state near tier, lag0", "state", 128, 16, 3, 1 << 13, True),
    ("K8 state 2^17 section", "state", 128, 2, 8, 1 << 16, False),
    ("K8 state 2^16 far tier", "state", 128, 4, 8, 1 << 15, False),
    ("K7 far tier", "ring", 128, 4, 14, 1 << 15, None),
    ("K7 collapsed", "ring", 128, 16, 58, 1 << 13, None),
    ("K7 narrow tiles", "ring", 128, 4, 14, 64, None),
    ("K15 staged", "mac", 128, 48, 47, 1024, 0),
]


def _source(text: str, layout: dict) -> str:
    for name, value in layout.items():
        pat = re.compile(rf"constexpr int {name} = \d+;")
        if len(pat.findall(text)) != 1:
            raise SystemExit(f"ring_mac_layouts: {name} is not once in {SRC}")
        text = pat.sub(f"constexpr int {name} = {value};", text)
    return text


def _registers(log: str) -> list:
    """ptxas's register lines of the ring_mac<TU> instantiations."""
    out = []
    for entry, lines in ptxas(log, "ring_mac", ("registers",)).items():
        tu = re.search(r"ring_macILi(\d+)E", entry).group(1)
        out += [f"TU {tu}: {line}" for line in lines]
    return out


def _change(name: str, d: Path) -> None:
    (d / SRC).write_text(_source((d / SRC).read_text(), LAYOUTS[name]))


def _case(kind, c, t, p, k, extra, randn):
    """(launcher(so), plain outputs, outputs) at one shape: the same
    operands the wrappers pass (contiguous planes, H channels P K apart)."""
    dev = torch.device("cuda")
    h = [randn(c, p, k) * 1e-3 for _ in range(2)]
    y = [torch.empty(c, t, k, device=dev) for _ in range(2)]
    st = torch.cuda.current_stream().cuda_stream
    if kind == "mac":
        tp = extra + t + p
        x = [randn(c, tp, k) for _ in range(2)]
        want = hopper_kernels.lag_mac_plain(*x, *h, t, lead_skip=extra)

        def launch(so):
            return so.hst_lag_mac(x[0].data_ptr(), x[1].data_ptr(), h[0].data_ptr(),
                                  h[1].data_ptr(), p * k, y[0].data_ptr(), y[1].data_ptr(),
                                  c, tp, t, p, k, extra, st)
        return launch, want, y
    ring = [randn(c, p, k) for _ in range(2)]
    x = [randn(c, t, k) for _ in range(2)]
    new = [torch.empty(c, p, k, device=dev) for _ in range(2)]
    if kind == "ring":
        want = hopper_kernels.lag_mac_ring_plain(*ring, *x, *h)

        def launch(so):
            return so.hst_lag_mac_ring(ring[0].data_ptr(), ring[1].data_ptr(), x[0].data_ptr(),
                                       x[1].data_ptr(), h[0].data_ptr(), h[1].data_ptr(),
                                       p * k, y[0].data_ptr(), y[1].data_ptr(),
                                       new[0].data_ptr(), new[1].data_ptr(), c, t, p, k, st)
        return launch, want, y + new
    l0 = [randn(c, k) * 1e-3 for _ in range(2)] if extra else [None, None]
    want = hopper_fft.stream_state_plain(*x, *ring, *h, *l0)

    def launch(so):
        return so.hst_stream_state(x[0].data_ptr(), x[1].data_ptr(), ring[0].data_ptr(),
                                   ring[1].data_ptr(), h[0].data_ptr(), h[1].data_ptr(),
                                   p * k, *(v.data_ptr() if v is not None else None
                                            for v in l0), k, y[0].data_ptr(),
                                   y[1].data_ptr(), new[0].data_ptr(), new[1].data_ptr(),
                                   c, t, p, k, st)
    return launch, want, y + new


def main() -> None:
    names = variant_names(sys.argv[1:], LAYOUTS, __doc__)
    smi = card("ring_mac_layouts")
    libs = build("ring_mac_layouts", names, [SRC], _change,
                 ["hst_lag_mac_ring", "hst_lag_mac", "hst_stream_state"])
    for name, v in libs.items():
        print(f"{name} {LAYOUTS[name]}: {'; '.join(_registers(v.log))}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(3)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    for label, kind, c, t, p, k, extra in SHAPES:
        launch, want, out = _case(kind, c, t, p, k, extra, randn)
        row = []
        for name, v in libs.items():
            so = v.so
            rc = launch(so)
            torch.cuda.synchronize()
            if rc != 0:
                row.append(f"{name} CUDA error {rc}")
                continue
            row.append(f"{name} {device_ms(lambda: launch(so)):.4f} ms "
                       f"({snr(want, out):.1f} dB)")
        print(f"{label} ({c}, T {t}, P {p}, K {k}): {'; '.join(row)} [{smi}]", flush=True)
        del launch, want, out
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
