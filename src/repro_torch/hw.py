"""Hardware model of the port's target: one NVIDIA H100 SXM (sm_90a).

Every hardware-aware decision of the port (the schedule templates'
validity checks, the roofline bound of an operator, the search cache's
chip key) reads from this module.  The constants are the published ones
of NVIDIA's H100 SXM data sheet and the Hopper architecture white paper:

  * 132 streaming multiprocessors;
  * 227 KB (232,448 B) of shared memory a block can use (above 48 KB only
    as dynamic shared memory, after `cudaFuncSetAttribute`);
  * 65,536 32-bit registers per SM, at most 255 per thread, at most 1,024
    threads per block;
  * 50 MB of L2;
  * 80 GB of HBM3 at 3.35 TB/s;
  * 989 TFLOP/s dense bf16 on the tensor cores, 495 TFLOP/s dense TF32
    on the tensor cores, 67 TFLOP/s FP32 on the CUDA cores;
  * 228 KB (233,472 B) of shared memory an SM can give its blocks, out of
    its 256 KB of combined L1 and shared memory (the white paper).

Those rates assume the card's full 700 W power limit.  Launch and
residency limits come from the CUDA C++ programming guide (compute
capability 9.0): a grid's y dimension holds at most 65,535 blocks; an SM
holds at most 2,048 threads and 32 blocks, and the runtime reserves 1 KB
of shared memory per block.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# numpy knows bfloat16 only through ml_dtypes, which the port does not need
_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4, "float64": 8,
             "int8": 1, "int32": 4, "int64": 8, "uint8": 1, "bool": 1}


@dataclasses.dataclass(frozen=True)
class Chip:
    """One GPU."""

    name: str = "h100_sxm"
    sms: int = 132
    smem_per_block: int = 232_448          # B
    smem_per_sm: int = 233_472             # B
    smem_reserved_per_block: int = 1024    # B
    max_threads_per_sm: int = 2048
    max_blocks_per_sm: int = 32
    regs_per_sm: int = 65_536
    max_regs_per_thread: int = 255
    max_threads_per_block: int = 1024
    max_grid_y: int = 65_535
    l2_bytes: int = 50 * 1024**2
    hbm_bytes: int = 80 * 10**9
    hbm_bw: float = 3.35e12                # B/s
    peak_bf16_flops: float = 989e12        # dense, tensor cores
    peak_tf32_flops: float = 495e12        # dense, tensor cores
    peak_f32_flops: float = 67e12          # CUDA cores

    def peak_flops(self, dtype) -> float:
        """The f32 CUDA-core rate for 4-byte types, the bf16 tensor-core
        rate for narrower ones."""
        return self.peak_f32_flops if itemsize(dtype) >= 4 else self.peak_bf16_flops

    def resident_blocks(self, smem_bytes: int, threads: int) -> int:
        """Blocks of `threads` threads and `smem_bytes` of shared memory one
        SM holds at once, by its shared memory, threads and block slots
        (registers, fixed per kernel at compile time, are not counted)."""
        by_smem = self.smem_per_sm // (smem_bytes + self.smem_reserved_per_block)
        return max(1, min(by_smem, self.max_threads_per_sm // threads,
                          self.max_blocks_per_sm))


H100 = Chip()


def itemsize(dtype) -> int:
    name = str(dtype).replace("torch.", "")
    return _ITEMSIZE.get(name) or np.dtype(name).itemsize


def align_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def matmul_flops(m: int, n: int, k: int) -> float:
    return 2.0 * m * n * k


def bytes_of(shape, dtype) -> int:
    return int(np.prod(shape)) * itemsize(dtype)
