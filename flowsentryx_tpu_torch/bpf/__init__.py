"""In-repo eBPF toolchain: assembler, raw-syscall loader, XDP programs.

This package replaces the clang/libbpf build dependency the image lacks
(there is no clang with a BPF target anywhere in the environment — see
docs/BPF_BUILD.md) with a first-party toolchain:

* :mod:`isa` — BPF instruction encodings (the stable kernel uapi ISA);
* :mod:`asm` — a macro assembler (labels, map relocations, helpers);
* :mod:`loader` — raw ``bpf(2)`` syscall loader: map create/update,
  PROG_LOAD with the real in-kernel verifier, PROG_TEST_RUN with
  crafted packets, and an mmap'd ringbuf consumer;
* :mod:`progs` — the fsx XDP fast path, hand-assembled, mirroring
  kern/fsx_kern.c instruction for instruction in semantics;
* :mod:`verifier` — an in-repo static verifier: the kernel verifier's
  safety contract (packet bounds proofs, stack init, map-value bounds,
  helper contracts, CFG checks) checkable with no kernel in the loop;
  runs automatically before every prog_load and image seal;
* :mod:`contracts` — the cross-layer wire-format contract checker
  (schema ↔ generated header ↔ baked progs.py offsets ↔ sealed
  images), surfaced with the verifier as ``fsx check``;
* :mod:`image` — the sealed ``FSXPROG`` program images the C++ daemon
  loads (``kern/build/*.img``);
* :mod:`blacklist`, :mod:`rules` — the operator's edits of the pinned
  blacklist, rule and config maps (``fsx block``/``unblock``/
  ``blacklist``/``rules``/``config --pin``).

Counterpart of ``flowsentryx_tpu/bpf/``: the same programs, byte for
byte, and the same images, reports and map layouts.  The plane runs in
the Linux kernel, not on the card, and imports neither torch nor
anything of the reference: it reads the schema's numpy half
(:mod:`flowsentryx_tpu_torch.core.wire`).  Nothing makes a syscall at
import.

The original system loads its program with ``bpftool prog load`` and a
BCC stub; this package performs the same
kernel handshake (BPF_MAP_CREATE/BPF_PROG_LOAD/BPF_PROG_TEST_RUN
syscalls) without external tooling, so the data plane is testable
against the real verifier inside any container that grants bpf().
"""

from flowsentryx_tpu_torch.bpf.loader import bpf_available  # noqa: F401
