"""Time row 6's f32 serving kernel of this tree against a variant source of
``csrc/block_f32.cu`` (an earlier version, say) in one process on the card.

    python3 pmce_tpu_torch/tools/compare_block_f32.py VARIANT.cu

Both are built with the port's nvcc flags (the variant with ``csrc/`` on
its include path) into separate libraries under ``pmce_tpu_torch/_build/``;
the wrapper looks the library up at call time, so each timing swaps one
in. The variant must export ``pmce_block_fwd_f32``. At the f32 serving
forward's two shapes ([4096, 19, 256] spatial, [4864, 16, 256] temporal,
hid 512, the post-norm; TF32 off) it prints, over 3 rounds in turns
(variant, tree, tree, variant), the median of 20 CUDA-event-timed wrapper
calls after 5 warm-ups, each build's median, the plain version's, whether
the two builds give the same bits and the tree's largest difference from
the plain version relative to its largest magnitude.
"""

from __future__ import annotations

import hashlib
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from pmce_tpu_torch.ops import _cuda  # noqa: E402
from pmce_tpu_torch.ops import fused_attention as fa  # noqa: E402


class VariantLibrary(_cuda.CudaLibrary):
    """A block_f32 source outside ``csrc/``, built beside the tree's."""

    def __init__(self, src: Path):
        super().__init__("block_f32", "pmce_block_f32_error_string",
                         _cuda.BLOCK_F32.signatures)
        self.src = src

    @property
    def path(self) -> Path:
        digest = hashlib.sha1(self.src.read_bytes()).hexdigest()[:12]
        return _cuda.BUILD_DIR / f"block_f32_variant-{digest}.so"

    def build_command(self):
        out = self.path
        tmp = out.with_suffix(".tmp")
        return ([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC),
                 "-o", str(tmp), str(self.src)], tmp, out)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("compare_block_f32: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    builds = {"variant": VariantLibrary(Path(sys.argv[1]).resolve()),
              "tree": _cuda.BLOCK_F32}
    _cuda._build(list(builds.values()))
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(2)
    for clips, N in ((cs.B * cs.T, cs.J), (cs.B * cs.J, cs.T)):
        x, params, _, _ = cs.block_case(rng, dev, clips, N, 0.0)
        x = x.detach().float()
        params = tuple(t.detach() for t in params)

        def call():
            return fa.transformer_block(x, params, 8)

        outs, times = {}, {tag: [] for tag in builds}
        with torch.no_grad():
            for _ in range(3):
                for tag in ("variant", "tree", "tree", "variant"):
                    _cuda.BLOCK_F32 = builds[tag]
                    outs[tag] = call()
                    times[tag].append(cs.median_ms(call, iters=20, warmup=5))
            _cuda.BLOCK_F32 = builds["tree"]
            y = fa.transformer_block_plain(x, params, 8)
            plain_ms = cs.median_ms(
                lambda: fa.transformer_block_plain(x, params, 8), iters=10)
        rel = float((outs["tree"] - y).abs().max() / y.abs().max())
        print(f"[{clips}, {N}, {cs.C}]: " + "; ".join(
            f"{tag} " + ", ".join(f"{t:.3f}" for t in ts)
            + f" (median {statistics.median(ts):.3f})"
            for tag, ts in times.items())
            + f" ms; plain {plain_ms:.3f} ms; the builds give the same bits: "
            f"{torch.equal(outs['variant'], outs['tree'])}; tree vs plain "
            f"{rel:.3g}", flush=True)


if __name__ == "__main__":
    main()
