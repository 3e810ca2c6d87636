"""The least time the feasibility precompute's work needs on the chip,
from its shapes alone: frozen copies of the per-kernel operation and byte
counts of ``karpenter_tpu_torch/ops/kernels.py`` (K1 combine_compat, K2
catalog_feasibility, K3 exist_feasibility) and the chip's peaks.

The counts stay here, where the program cannot change them: a kernel that
is fused, replaced or renamed is read against the same work.

Peaks (NVIDIA H100 SXM, 700 W): HBM 3.35e12 bytes/s, the data sheet's;
INT32 3.35e13 operations/s, derived in NVIDIA's H100 architecture
whitepaper terms: 64 INT32 lanes a streaming multiprocessor x 132 of them
x 1.98 GHz x 2, a multiply-add counted as two operations (the kernels'
``acc |= x & y`` is one three-input LOP3, counted as its two operations).
A card below 700 W reaches less; the run prints its power limit beside
the share."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12


def zone_words_bytes(Z: int) -> int:
    """Bytes of one packed zone bitfield: uint8 words up to 8 zones, uint16
    up to 16, uint32 past that."""
    bits = 8 if Z <= 8 else (16 if Z <= 16 else 32)
    return (bits // 8) * -(-Z // bits)


def enc_bytes(rows: int, K: int, W: int) -> int:
    """An encoded requirement row set: int32 mask words, three bool flags
    and two int32 bounds a key."""
    return rows * K * (4 * W + 3 + 8)


def arg_bytes(G=0, M=0, T=0, N=0, K=0, W=0, R=0, O=0, Z=0) -> dict:
    """Bytes of each device argument of a precompute launch."""
    enc = enc_bytes
    return dict(group=enc(G, K, W), template=enc(M, K, W), it=enc(T, K, W),
                group_req=4 * G * R, daemon=4 * M * R, alloc=4 * T * R,
                template_its=M * T, offerings=9 * T * O, zone_values=4 * Z,
                allow_undefined=K, tol_template=G * M, exist=enc(N, K, W),
                exist_avail=4 * N * R, tol_exist=G * N)


def combine_compat(M, G, K, W) -> tuple:
    """K1: (operations, bytes)."""
    a = arg_bytes(G=G, M=M, K=K, W=W)
    out = enc_bytes(M * G, K, W) + M * G
    return (2 * M * G * K * W + 12 * M * G * K,
            a["template"] + a["group"] + a["allow_undefined"] + out)


def catalog_feasibility(M, G, T, K, W, R, O, Z) -> tuple:
    """K2: (operations, bytes); it reads K1's outputs."""
    a = arg_bytes(G=G, M=M, T=T, K=K, W=W, R=R, O=O, Z=Z)
    k1_out = enc_bytes(M * G, K, W) + M * G
    inputs = k1_out + sum(a[k] for k in (
        "it", "group_req", "daemon", "alloc", "template_its", "offerings",
        "zone_values", "tol_template"))
    out = G * M * T * (zone_words_bytes(Z) + 2) + G * M * Z
    return (M * G * T * (2 * K * W + 8 * K + 3 * R + 2 * O * Z),
            inputs + out)


def exist_feasibility(G, N, K, W, R) -> tuple:
    """K3: (operations, bytes)."""
    a = arg_bytes(G=G, N=N, K=K, W=W, R=R)
    inputs = sum(a[k] for k in ("group", "group_req", "exist",
                                "exist_avail", "tol_exist"))
    return (G * N * (2 * K * W + 9 * K + 2 * R), inputs + 5 * G * N)


def least_seconds(shape: dict) -> float:
    """The least time of one precompute at ``shape`` (G, M, T, N, K, W, R,
    O, Z): each kernel's larger of bytes over the HBM rate and operations
    over the INT32 rate, summed over K1, K2 and, with nodes, K3."""
    s = shape
    costs = [combine_compat(s["M"], s["G"], s["K"], s["W"]),
             catalog_feasibility(s["M"], s["G"], s["T"], s["K"], s["W"],
                                 s["R"], s["O"], s["Z"])]
    if s["N"]:
        costs.append(exist_feasibility(s["G"], s["N"], s["K"], s["W"],
                                       s["R"]))
    return sum(max(b / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)
               for ops, b in costs)
