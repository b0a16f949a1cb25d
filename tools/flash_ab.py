#!/usr/bin/env python3
"""Flash attention of several checkouts of this repository, in turns, on
one CUDA card: the readings of the bf16 flash kernels before and after a
change to ``src/repro_torch/csrc/flash_attention.cu``.

    python3 tools/flash_ab.py [--train] TREE [TREE ...]

Each TREE is the root of a checkout (``git archive`` of a commit unpacked
into a git-ignored directory, or ``.`` for this one); give them in turns
(parent, change, change, parent) to compare two versions on one card. Each
runs in a process of its own, on its own ``src/repro_torch`` and its own
``chip_smoke.py``, and prints one JSON line a reading, each with ``tree``
and ``run``:

- build: ``nvcc`` of the tree's ``flash_attention.cu`` (seconds), ptxas's
  registers and spills of each kernel, and the SASS opcode counts of each
  flash kernel (``_build.sass_counts`` of THIS checkout, run on the
  tree's library);
- times: the tree's ``chip_smoke.flash_times`` (forward, backward,
  trainable: kernel, plain and SDPA ms beside the bound) at :data:`CASES`,
  the same for every tree, and the backward's device ms by CUDA kernel
  (``chip_smoke.device_ms_by_kernel``, torch.profiler);
- with ``--train``: the tree's train_moe (Qwen3-30B-A3B, 1 layer),
  train_vlm (Qwen2-VL 2B) and train_encdec (Whisper large-v3) phases, each
  with two profiled steps of the kernels' route (``flash_device_ms``).

Every number is taken on the card in this run; the card's name and power
limit come first. Exits 1 if a tree's run fails.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

# (B, Hq, Hkv, S, D, causal, window, dtype), S one length or (Sq, Sk): the
# bf16 families' step shapes (chip_smoke.FLASH_FAMILIES), the MoE step's,
# and the f32 training step's (chip_smoke.FLASH_MAIN)
CASES = [
    (2, 20, 20, (256, 1500), 64, False, 0, "bfloat16"),  # whisper cross
    (2, 20, 20, 1500, 64, False, 0, "bfloat16"),  # whisper encoder
    (2, 20, 20, 256, 64, True, 0, "bfloat16"),    # whisper decoder
    (2, 32, 8, 256, 128, True, 0, "bfloat16"),    # jamba
    (2, 12, 2, 256, 128, True, 0, "bfloat16"),    # qwen2-vl
    (2, 32, 4, 256, 128, True, 0, "bfloat16"),    # qwen3-moe
    (2, 16, 16, 256, 64, True, 0, "float32"),     # gpt-2 medium
]


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def load_module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def run_tree(tree: Path, run: int, train: bool) -> None:
    """One tree's readings, in this process (``--child``)."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cs = load_module("chip_smoke", tree / "chip_smoke.py")  # puts src first
    import torch
    from repro_torch.kernels import _build

    if not Path(_build.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"{_build.__file__} is not under {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    here_build = load_module("_build_here", HERE / "src" / "repro_torch"
                             / "kernels" / "_build.py")
    tag = {"tree": str(tree.relative_to(HERE)) or ".", "run": run}
    t0 = time.perf_counter()
    lib = _build.build("flash_attention")
    emit(**tag, reading="build", seconds=time.perf_counter() - t0,
         ptxas=[{**r, "function": cs.kernel_name(r["function"])}
                for r in _build.ptxas_report("flash_attention")],
         sass={cs.kernel_name(k): v for k, v in here_build.sass_counts(
             lib, "flash").items()})
    gen = torch.Generator(device="cuda").manual_seed(4321)

    def operands(B, Hq, Hkv, S, D, dtype):
        """q, k, v, do as (B, H, S, D) views of (B, S, H, D) tensors, as
        chip_smoke.phase_flash makes them."""
        Sq, Sk = cs.seq_lens(S)
        return [torch.randn((B, L, H, D), generator=gen, device="cuda")
                .to(getattr(torch, dtype)).transpose(1, 2)
                for H, L in ((Hq, Sq), (Hkv, Sk), (Hkv, Sk), (Hq, Sq))]

    from repro_torch.kernels import flash_attention as fa

    for case in CASES:
        res = cs.flash_times(torch, case, operands)
        B, Hq, Hkv, S, D, causal, window, dtype = case
        q, k, v, do = operands(B, Hq, Hkv, S, D, dtype)
        kw = dict(causal=causal, window=window)
        o, lse = fa.flash_attention(q, k, v, **kw)
        res["bwd_by_kernel"] = cs.device_ms_by_kernel(
            torch, lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, **kw))
        emit(**tag, reading="times", **res)
        del q, k, v, do, o, lse
    if train:
        cs.phase_train(torch, profile="kernels", name="train_moe",
                       cfg=cs.moe_config(), readings=cs.moe_readings)
        cs.phase_train_vlm(torch, "kernels")
        cs.phase_train_encdec(torch, True)


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        run_tree(Path(argv[1]).resolve(), int(argv[2]), argv[3] == "1")
        return 0
    train = "--train" in argv
    trees = [Path(a).resolve() for a in argv if a != "--train"]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    emit(reading="device", nvidia_smi=smi)
    failed = 0
    for run, tree in enumerate(trees):
        t0 = time.perf_counter()
        rc = subprocess.run([sys.executable, __file__, "--child", str(tree),
                             str(run), "1" if train else "0"],
                            cwd=tree).returncode
        emit(reading="tree_done", tree=str(tree), run=run, rc=rc,
             seconds=time.perf_counter() - t0)
        failed += rc != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
