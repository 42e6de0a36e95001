#!/usr/bin/env python3
"""Smoke run of lambdaworks_kzg_tpu_torch on one NVIDIA card (built for H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printed with its seconds:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. nvcc builds the eighteen kernels and the three field checks from
     lambdaworks_kzg_tpu_torch/csrc (one nvcc per source, all at once,
     linked into one library), and beside it g++ the native tier
     (csrc/native/bls12_381.cpp, native.py); ptxas' report, and per pairing kernel its
     registers and spills with the levels, linear waves, products and
     inversions of one run at B = 2 (counted from its level program);
     fr_evaluate, fr_quotient and fr_quotient_in_domain (each cluster form
     too) must not call fr::inv, and g1_fold's registers are printed;
  3. each kernel against its plain PyTorch version on the card, limb for
     limb: fp::sqr against fp::mul(a, a) and the plain square on random
     elements and on 0, 1, p - 1 and R mod p; the cooperative field of
     fp_coop.cuh (fp_coop_check: mul, sqr, add, sub, is_zero, eq) against
     fp::mul, fp::sqr and the plain field on all pairs of 0, 1, p - 1,
     p - 2, 2, R mod p and random pairs; g1_fixedbase_table against
     g1_ops.fixedbase_table at c = 4 and 8 on 256 lanes of the mainnet
     basis with every 7th lane invalid, and at the mainnet shape (4096
     lanes, c = 8); g1_madd, g1_add and g1_dbl at lane counts 1 to 4096 (and 200,
     a partly filled second block) with random and exceptional lanes (P at
     infinity, P == Q, P == -Q, dead lanes); g1_fold against g1_ops.fold
     at K = 2, 3, 4 rows on 12 lanes, and at the meshes' shapes (K = 2 on 3
     lanes, K = 4 on 6), with rows at infinity, equal rows and Z != 1,
     each timed; g1_bucket_accumulate and g1_bucket_reduce (at the
     path's chunk length, msm.chunk_length) against
     g1_ops.accumulate_chunks and reduce_chunks on the committed mainnet
     table at c = 8 for one and for six seeded blobs and for a blob of
     4096 elements 0x0101..01 and one of 4096 ones (the digits in one
     bucket), on a synthetic table of four points and their negations
     repeated (so runs of members double, cancel to infinity and lift
     again, beside empty and dead buckets) at c = 4 and c = 12, and
     g1_bucket_reduce on synthetic chunk partials there (the merge's and
     the fold's equal, opposite and infinite operands); then one real
     quotient (a dense seeded blob at a seeded z, evaluated and divided on
     the card and equal to the host's): both MSM kernels against their
     plain versions on its members, and its MSM on the kernels against
     the host oracle g1_msm in affine form; g1_window_combine against
     g1_ops.combine_windows at c = 4, 8 and 12 on the window sums of one
     MSM (all finite, Z != 1) and of three (combine_cases.combine_edge_sums:
     windows and a whole run at infinity, Horner, comb and last adds of
     equal and of opposite points), each shape timed on finite sums, its
     critical path logged (doublings, adds, products deep);
     g1_decompress on the 4096
     mainnet monomial x's and on non-square and edge x's, g1_scalar_mul
     on 2048 lanes of per-lane 255-bit scalars (0, r, r - 1 among them)
     and on 4096 lanes of the broadcast 1/4096, and in the conversion's
     split mode on 2048 lanes of the inverse FFT's last-stage twiddles
     (a sample of the lanes in G1 also against the host [k]P) and on 4096
     lanes of the broadcast 1/4096, g1_fft_stage on 4096 points at the
     inverse FFT's stage lengths 2, 64 and 4096 (butterflies where t ==
     even among them), g1_subgroup_mask on 4096 monomial points and 256
     sums, all over lanes at infinity, with Z != 1 and outside G1, the
     last also against the host g1_in_subgroup on a sample; then
     g1_decompress, both modes of g1_scalar_mul and g1_subgroup_mask at
     1, 12, 31, 33 and 128 lanes (the block and warp edges);
     pairing_miller_loop and pairing_final_exp against
     pairing_ops.miller_loop_jac and final_exp_check at B = 2 (a true
     check) and B = 5 (a false one, two pairs with a member at infinity),
     on points with Z != 1, FE^3 also against the host pairing cubed; the
     plain versions run once per shape (scripts/pairing_profile.py counts
     their launches per check; scripts/pairing_probe.py splits the
     kernels' time); fr_check (fr.cuh's product, square, sum, difference,
     negation, inverse and conversions) against the plain FR on 4096
     elements with 0, 1, r - 1, r - 2, 2 and R mod r among them, and at
     the blob domain (n = 4096) on 1, 6 and 64 blobs fr_to_mont against
     FR.to_mont and fr_quotient_in_domain (m = 0, 1, n - 1 and a seeded
     m, each alone at B = 1, all four among the blobs at 6 and 64) on the
     plain limbs and their root table against FrDomain's plain version
     (and blob 0 against the host's quotient), fr_evaluate and
     fr_quotient on the plain ones and one z table as FrDomain.open_mont
     runs them (against its CPU route's plain versions, on the card; the
     table, which the kernels only read, equal to the host's after them),
     blob 0 also against the host's evaluation and quotient, fr_evaluate
     at roots of unity equal to the stored elements; each timed (CUDA
     events, on the main path's inputs) beside its plain version's one
     call and its bound;
 3b. the setup conversion: testdata/trusted_setup.txt converted on the
     card into a temporary cache_dir, its lagrange, monomial and g2
     byte-equal to cache/srs_mainnet.npz, with exactly one g1_decompress,
     one g1_subgroup_mask, 12 g1_fft_stage and one g1_scalar_mul (split
     mode, [1/n]) launches and nothing else; its stages timed apart twice
     (host parse, G2 on the host, the device part as
     srs.convert_g1_device runs it, the affine step); testdata/trusted_setup_4.txt
     converted byte-equal to its conversion by the host oracles (per-point
     decompression and the host G1 FFT);
 3c. the NTT at n = 4096 on the card (PyTorch ops, ops/ntt.py): forward
     and inverse equal host/fft.fr_fft, the round trip, and a seeded
     blob's coefficients (utils/blob.py) equal the inverse NTT; each
     direction timed and its launches counted under the profiler;
  4. EIP4844Context(converted setup, device="cuda") builds the
     fixed-base table with one g1_fixedbase_table launch and no g1_dbl
     launch, and the table must equal
     cache/fixedbase_62bcf72bba2b37b8_c8.npz bit for bit;
  5. the ten blob_to_kzg_commitment consensus vectors;
  6. three seeded random blobs through blob_to_kzg_commitment and a
     batch of six through blob_to_kzg_commitment_batch (twice), timed
     with CUDA events; one blob also through the plain PyTorch path on
     the card;
  7. of the 46 compute_kzg_proof and 12 compute_blob_kzg_proof vectors,
     every one whose output is null and the first two others of each, bit
     for bit, on the card (phase 12 runs all of them through the C ABI);
  8. the verify path on the default context: the 93 verify_kzg_proof, 24
     verify_blob_kzg_proof and 23 verify_blob_kzg_proof_batch vectors (the
     pairing check and a batch's blob evaluations on the card; the single
     checks' decompressions, [y]G1, [z]G2 and blob evaluation on the
     native tier), each verdict or
     KZGError as the vector has it, timed; every vector launches one
     pairing_miller_loop and one pairing_final_exp per pairing check it
     makes, and no host pairing runs; each batch of n >= 2 that passes
     its input checks launches g1_decompress and g1_subgroup_mask once,
     fr_evaluate once (its blob evaluations),
     g1_bucket_accumulate, g1_bucket_reduce and g1_window_combine once
     (its three linear combinations one batch of generic MSMs over the
     union of its points; no table) and each
     pairing kernel once; seeded batches of 6 and 64 blobs, committed and
     proved on the card, verify true, and false with proofs 0 and 1
     swapped, twice each, timed, one true batch of each size split into
     its stages, and the batch of 6's batch of generic MSMs split into sort,
     accumulate, reduce and combine (device time under the profiler); a generic MSM of a blob
     over the 4096 Lagrange points equals its commitment;
 8b. the 140 verify vectors again on the host pairing tier,
     EIP4844Context(..., config=KZGConfig(device_pairing=False)): the same
     verdicts, timed, with exactly phase 8's vector launches less one
     launch of each pairing kernel per check, and one host pairing per
     check, on the native tier; then 10 of them (per function a null
     one, and true and false ones) with LWKZG_NATIVE=0: the same
     verdicts, one Python-int pairing per check;
  9. the prove path: three seeded blobs through compute_blob_kzg_proof
     and a batch of six through compute_blob_kzg_proof_batch (twice),
     timed with CUDA events, each call launching each MSM kernel and each
     of fr_evaluate and fr_quotient once and the batch equal
     to the singles, and compute_kzg_proof at a root of unity
     (fr_quotient_in_domain once and no other Fr kernel; y the stored
     element, the proof verified); one proof's launches under
     torch.profiler; then
     for one blob and for six the Fr part (fr_ms: the z table's
     transfer, the evaluation and the quotient) and the MSM timed apart,
     and counted under torch.profiler after a warm-up step (launches;
     the Fr part's must hold both Fr kernels and the copy and be at most
     FR_PART_MAX; device busy), the same for the Fr part of a proof at a
     root of unity (FrDomain.quotient: the root table's transfer and one
     fr_quotient_in_domain launch), and the host syncs of a proof and of a
     batch counted;
 10. each kernel timed with CUDA events: the MSM kernels at the path's
     shapes for one blob and for six (seeded random blobs, c = 8), then
     at B = 1 a random blob beside the 0x0101..01 blob and the blob of
     ones (each one's ratio to the random blob's), and the accumulation
     on the real quotient, madd at the 2048 lanes of one
     blob's bucket grid, add at 1024, dbl at 4096, on random lanes, the
     table kernel at the mainnet shape, g1_decompress on 4096, 128 and
     12 x's, g1_scalar_mul in the split mode on [1/n] (4096 lanes) and on
     an FFT stage's 2048 lanes (the last stage's twiddles), with the bound
     of the split schedule's work and, beside it, of the
     double-and-add's on the same scalars, g1_fft_stage at stage lengths
     2 and 4096 of the mainnet inverse FFT, g1_subgroup_mask on 4096, 128
     and 12 points, the two field checks on 4096 elements, and both
     pairing kernels at B = 2 (with phase 2's level counts and ptxas
     figures), and the Fr kernels and g1_window_combine at phase 3's
     times; plain times are phase 3's at the same shapes where it ran
     them; then
     utils/profiling.py's roofline table (g1_madd, g1_add,
     g1_dbl chained in one CUDA graph at 8192 lanes, the plain Fp product),
     and g1_fold at phase 3's times;
 11. the multi-device tier (lambdaworks_kzg_tpu_torch/parallel) on the
     converted setup, on logical meshes over the card named four times,
     (1, 1), (2, 2) and (1, 4), and on a mesh of every card when there is
     more than one (the device count is printed): each backend's init
     builds one table per device, and each shard's table equals its rows
     of cache/fixedbase_62bcf72bba2b37b8_c8.npz bit for bit; the 10
     blob_to_kzg_commitment vectors; batches of 6 and 5 seeded blobs equal
     phase 6's commitments, and compute_blob_kzg_proof_batch of 6 phase
     9's proofs, each call in exactly D P g1_bucket_accumulate and
     g1_bucket_reduce launches and, where P > 1, D g1_fold launches (one
     fold a row) and nothing else; a generic sharded MSM of a blob over the
     4096 Lagrange points equals its commitment by points, windows and
     auto, each in its exact launches and no table (by points an
     accumulation and a reduce a shard and the fold, by windows one a
     shard, and one g1_window_combine); the 23 verify_blob_kzg_proof_batch
     vectors, and phase 8's
     seeded batches of 6 and 64 verified true and false, each in its
     exact launches (the 64's linear combinations sharded); batches of 6
     timed with CUDA events (a logical mesh is one card doing every
     shard's work: no multi-card time); the sharded NTT and inverse at
     n = 4096 on 2 and 4 devices equal host/fft.fr_fft;
 12. the C ABI (lambdaworks_kzg_tpu_torch/capi): cc builds the shim into
     _build/liblambdaworks_kzg_tpu_torch.so, loaded with ctypes into this
     process; load_trusted_setup_file on a FILE * of
     testdata/trusted_setup.txt makes a context on the card (one
     g1_fixedbase_table launch); all 208 consensus vectors through the
     seven C functions, each output byte-equal to the vector's and
     C_KZG_BADARGS on a null one (a vector the fixed-size ABI cannot
     express, a wrong length, must expect null), each call launching
     g1_bucket_accumulate and g1_bucket_reduce once for a commitment or a
     proof, and for a proof fr_evaluate and fr_quotient once
     (fr_quotient_in_domain in their place at a root of unity), the
     pairing kernels once for a verdict, a batch of n >= 2
     VERIFY_BATCH_LAUNCHES, and nothing for a BADARGS call (a failed
     batch: at most its decompression and subgroup check); the blst G1 and
     G2 tables' first and last entries against the setup file's points;
     load_trusted_setup on the file's points (the same tables, one table
     launch) and on 4095 G1 points (BADARGS); blob_to_kzg_commitment,
     compute_blob_kzg_proof and verify_blob_kzg_proof timed through the
     ABI and on phase 4's context in turns, medians of 5, equal results;
     then capi/kzg_client.c built against the port's header and library
     and run as a C program (its interpreter embedded, PYTHONPATH the
     repository root and this interpreter's site directories): it loads
     the setup from a FILE *, commits to a seeded blob, proves and
     verifies it, and prints what the same calls gave in this process;
 13. the native tier on the card's host: its g++ seconds (phase 2);
     verify_kzg_proof on the default context with the tier on and with
     LWKZG_NATIVE=0, the mainnet conversion's G2 stage both ways, and
     the three sizes a CPU backend sends to the tier, natively and on the
     card: 12 decompressions (g1_decompress + g1_subgroup_mask), the three
     linear combinations of a batch of 6 (natively one MSM of 6, 6 and 7
     points each; on the card one batch of three over 13), 6 blob evaluations
     (on the card one fr_evaluate launch); each in
     turns, medians of 5, equal results;
 14. parallel/distributed.py: `python3 chip_smoke.py --rank ...` processes
     on localhost, world size 1 (nccl), then 2 and 4 ranks on gloo
     sharing the one card; each rank initializes the group (which must
     choose that backend), loads the mainnet setup, commits to phase 6's
     blob 0 with the points axis across the ranks, and to phase 6's batch
     of 6 and verifies phase 8's batch of 6 (true, and false with proofs
     0 and 1 swapped) with the data axis across them, and runs phase 3c's
     NTT at n = 4096 and its inverse with the data axis across the ranks
     and with the points axis across them (parallel/ntt.py: one
     batch_isend_irecv exchange and one all_gather, through host tensors
     on gloo), each MSM across ranks folding the gathered partials in one
     g1_fold launch, each
     equal to those phases' results in every rank, and prints its times
     and launches; a failed rank fails the phase;
 15. the generic MSM (ops/msm.msm_device, JAX's windowed one: the
     window sums on the MSM kernels, then g1_window_combine; no table)
     at the JAX package's bench shapes: n = 2^16 at c = 8, n = 2^20 at
     c = 12, and n = 2^20 at c = 12 with 248-bit scalars, over the 4096
     mainnet Lagrange points tiled, equal in affine form to the native
     tier's 4096-point MSM of the scalars folded per point mod r; per
     shape its ms (CUDA events), its stages (sort, accumulate, reduce,
     combine; device time under the profiler), its launches (one of each kernel) and the peak allocated
     memory, then the route before it (a table build and the fixed-base
     MSM over it) timed and measured the same way in the same process,
     and the 2^20 MSM's 255-bit / 248-bit ratio;
 16. the fuzz harnesses (lambdaworks_kzg_tpu_torch/fuzz): FUZZ_ITERS
     iterations of fuzz_differential.py on the degree-4 setup through a
     CPU context and the card's context (tier on, LWKZG_NATIVE=0, and
     the host pairing tier), zero findings;
     gen_corpus.py on the card, and the combined C target of
     fuzz_capi.c (replay mode) on the generated seeds and a stride of the
     vector seeds with LWKZG_BACKEND=device, no internal error;
 17. the bench (lambdaworks_kzg_tpu_torch/bench.py): `python3 -m
     lambdaworks_kzg_tpu_torch.bench --reps 3` in a process of its own on
     phase 2's _build/, killed after 240 s; it must exit 0 with one JSON
     line on this card, _build/ warm, BASELINE.json's four configurations
     that one card runs `ok`, every time and rate finite and positive, and
     each kernel of its path launched; the line is logged.
Launch counts are zeroed just before each path and read just after it:
the conversion (phase 3b), the commit path (phases 4 to 6), the verify
path (phase 8, after its seeded blobs are committed and proved), the
host pairing tier's verify path (phase 8b), the prove path (phase 9,
from its first proof to its last), the mesh path (phase 11), the C
ABI's path (phase 12, less the launches of its Python context's timed
calls), the distributed path (phase 14, in each rank from its first
context to its last call, summed over the ranks and worlds), the generic
MSM path (phase 15, each shape's msm_device call), the fuzz path
(phase 16, the differential in this process) and the bench's path
(phase 17, the whole run, counted in the bench's process); phase
3b checks the conversion's exact launches, phase 4 that the table build
made one table launch and no g1_dbl launch, phases 6 and 9 each call's
launches (the MSM kernels once, and a proof's Fr kernels), and the Fr
part of phase 9's split, phase 8 the launches of each vector
and batch, 8b none of the pairing kernels, phases 11 and 12 each call's,
phase 14 that the path launched each of DIST_KERNELS, phase 15 one of
each of GENERIC_KERNELS per shape.
The line before the last is {"kernels": [...]}, with each kernel's
launches on the eleven paths; the last is {"ok": true, "device": {...}}. Any
failure ends the run with a non-zero exit and without those lines.
"""

import contextlib
import ctypes
import json
import os
import random
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "lambdaworks_kzg_tpu_torch"
FIXEDBASE = os.path.join(HERE, "cache", "fixedbase_62bcf72bba2b37b8_c8.npz")
VECTORS = os.path.join(HERE, "testdata", "consensus", "blob_to_kzg_commitment", "small")

sys.path.insert(0, HERE)
try:  # the H100's peak rates, the IMADs of an Fp product and a point op, the timers
    from lambdaworks_kzg_tpu_torch.ops.msm import chunk_length  # the MSM's L for a batch
    from lambdaworks_kzg_tpu_torch.utils.profiling import (FP_OPS, HBM_BYTES_PER_S, IMAD_PER_FP_MUL,
                                                           IMAD_PER_FP_SQR, IMAD_PER_FR_MUL,
                                                           IMAD_PER_FR_REDC, IMAD_PER_FR_SQR,
                                                           IMAD_PER_S, card_line, device_work,
                                                           events_ms, host_ms, time_ms)
except ImportError as e:
    sys.exit(f"chip_smoke: {PKG}/ must sit beside this script ({e})")
FP_BYTES = 48
FR_BYTES = 32


def op_imads(op: str) -> int:
    muls, sqrs = FP_OPS[op]
    return muls * IMAD_PER_FP_MUL + sqrs * IMAD_PER_FP_SQR


def chain_ops(e: int, k: int) -> tuple:
    """(products, squarings) of a left-to-right sliding-window power a^e
    with the odd powers a, a^3 .. a^(2^k - 1) precomputed."""
    muls, sqrs = (2 ** (k - 1) - 1, 1) if k > 1 else (0, 0)
    bits, i, first = bin(e)[2:], 0, True
    while i < len(bits):
        if bits[i] == "0":
            sqrs, i = sqrs + 1, i + 1
            continue
        j = min(i + k, len(bits))
        while bits[j - 1] == "0":
            j -= 1
        if not first:
            muls, sqrs = muls + 1, sqrs + j - i
        first, i = False, j
    return muls, sqrs


def pow_imads(e: int, mul: int = IMAD_PER_FP_MUL, sqr: int = IMAD_PER_FP_SQR) -> int:
    """IMADs of a^e by the cheapest sliding window of 1 to 8 bits, at a
    product's and a squaring's IMADs (Fp's unless given)."""
    return min(m * mul + s * sqr for m, s in (chain_ops(e, k) for k in range(1, 9)))


def inv_imads() -> int:
    """IMADs of a^(p - 2) (5-bit window: 82 products and 378 squarings).
    fp::inv runs the 1-bit chain, 228 products and 380 squarings."""
    from lambdaworks_kzg_tpu_torch.constants import P

    return pow_imads(P - 2)


def fr_inv_imads() -> int:
    """IMADs of a^(r - 2) in Fr at its cheapest window. fr::inv runs a
    fixed 4-bit window, 252 squarings and 73 products."""
    from lambdaworks_kzg_tpu_torch.constants import R

    return pow_imads(R - 2, IMAD_PER_FR_MUL, IMAD_PER_FR_SQR)


def fr_kernel_work(name: str, n: int, blobs: int) -> tuple:
    """(bytes, IMADs) an Fr kernel needs at least for `blobs` blobs over the
    domain of n = 2^L: each input read once and each output written once,
    an element 32 bytes, whatever layout the kernel reads (the roots once
    for all blobs; fr_evaluate's and fr_quotient's z tables of L + 1
    values a blob), and per blob the fewest products the function takes,
    whichever schedule the kernel runs. The product of an aligned chunk
    of m bit-reversed roots' denominators is z^m - w_g in closed form, from
    the L - 1 squarings z^2 .. z^(n/2) and z^n:

    - fr_evaluate: y = (z N - (z^n - 1) sum_i e_i) / n with
      N = sum_i e_i prod_{j != i} (z - w_j) (as w = z - (z - w)), N by a
      tree of fraction sums whose denominators are known: 2 (n - 1)
      products, then 3 (z N, (z^n - 1) sum e, 1 / n), and L squarings; no
      inversion;
    - fr_quotient: the inversion of z^n - 1 (on the host for the kernel),
      then 1 / (z - w_i) down a tree whose node's is its parent's times
      its sibling's denominator, 2 (n - 1) products, and n products
      (e_i - y) / (w_i - z), plain with R^-1 folded into the inversion;
      L squarings;
    - fr_quotient_in_domain, z = w_m: 1 / (z - w_i) down the same tree
      from K = w_m / n (1 / prod_{i != m} (z - w_i), on the host), where
      the chunk of 2^l that holds m has product 2^l z^(2^l) / z (L
      products by the host's 1/z), 2 (n - 1) products; the n quotients;
      and q_m = -(1 / z) sum_{i != m} q_i w_i on them, n + 1 products: no
      inversion and no squaring, z's powers being roots the host looks
      up; it reads the table's L + 2 values and m (4 bytes);
    - fr_to_mont: one product an element;
    - fr_check on n lanes: two products (a b, to_mont), a squaring, an
      inversion and a reduction (from_mont) a lane.

    The inversion is `fr_inv_imads`."""
    levels = n.bit_length() - 1
    elems, roots = blobs * n * FR_BYTES, n * FR_BYTES
    table, ys = blobs * (levels + 1) * FR_BYTES, blobs * FR_BYTES
    inv = fr_inv_imads()
    sqrs = levels * IMAD_PER_FR_SQR
    quotient = blobs * ((3 * n - 2) * IMAD_PER_FR_MUL + sqrs + inv)
    if name == "fr_to_mont":
        return 2 * elems, blobs * n * IMAD_PER_FR_MUL
    if name == "fr_evaluate":
        return elems + roots + table + ys + FR_BYTES, blobs * ((2 * n + 1) * IMAD_PER_FR_MUL + sqrs)
    if name == "fr_quotient":
        return 2 * elems + roots + table + ys, quotient
    if name == "fr_quotient_in_domain":
        return (2 * elems + roots + blobs * ((levels + 2) * FR_BYTES + 4),
                blobs * (4 * n - 1 + levels) * IMAD_PER_FR_MUL)
    if name == "fr_check":
        return 10 * n * FR_BYTES, n * (2 * IMAD_PER_FR_MUL + IMAD_PER_FR_SQR + IMAD_PER_FR_REDC + inv)
    raise ValueError(name)


def bound(nbytes: int, imads: int) -> dict:
    """The least time the card could take for the work: the larger of the
    bytes over its memory rate and the IMADs over its multiply rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, imads / IMAD_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def decompress_imads(n: int) -> int:
    """IMADs g1_decompress needs for n lanes: x^3 (a squaring and a
    product), the power (p+1)/4 at its cheapest window (5 bits, the
    kernel's), y0^2 for the square test and one product out of
    Montgomery form."""
    from lambdaworks_kzg_tpu_torch.constants import FP_SQRT_EXP

    return n * (pow_imads(FP_SQRT_EXP) + 2 * IMAD_PER_FP_MUL + 2 * IMAD_PER_FP_SQR)


def ladder_imads(k: int) -> int:
    """IMADs of [k]P on a finite point of G1 by right-to-left double and
    add: bit_length - 1 doublings and popcount - 1 adds (the first add
    lands on the empty accumulator and needs no products)."""
    if k == 0:
        return 0
    return (k.bit_length() - 1) * op_imads("dbl") + (bin(k).count("1") - 1) * op_imads("add")


def window_imads(k: int) -> int:
    """IMADs of [k]P for a 128-bit k on a finite point of G1 by the split
    mode's schedule (g1_ops.window_mul): the table 0, P, .., 15P (7
    doublings and 7 adds), then from the top 4-bit window acc = T[digit]
    and per window 4 doublings and an add; while acc is at infinity its
    doublings need no products, and neither does the add that lifts it or
    an add of T[0]."""
    digits = [(k >> (4 * w)) & 15 for w in range(32)]
    ops = 7 * (op_imads("dbl") + op_imads("add"))
    started = digits[31] != 0
    for d in reversed(digits[:31]):
        if started:
            ops += 4 * op_imads("dbl") + (op_imads("add") if d else 0)
        started = started or d != 0
    return ops


def split_imads(k: int) -> int:
    """IMADs of g1_scalar_mul's split mode for one lane with scalar k < r:
    both 128-bit halves (`window_imads`), BETA X, and the final add."""
    k2, k1 = divmod(k, 0xD201000000010000 ** 2)
    return window_imads(k1) + window_imads(k2) + IMAD_PER_FP_MUL + op_imads("add")


def fft_stage_imads(twiddles) -> int:
    """IMADs g1_fft_stage needs for one stage on finite points of G1: per
    butterfly the split schedule's work on its twiddle (`split_imads`) and
    two adds."""
    return sum(split_imads(k) for k in twiddles) + 2 * len(twiddles) * op_imads("add")


def subgroup_imads(n_finite: int) -> int:
    """IMADs g1_subgroup_mask needs for n_finite lanes (lanes at infinity
    need none): two ladders by |x|, BETA X, and the cross-multiplied
    equality (6 products, 2 squarings)."""
    x_abs = 0xD201000000010000
    return n_finite * (2 * ladder_imads(x_abs) + 7 * IMAD_PER_FP_MUL + 2 * IMAD_PER_FP_SQR)


def table_imads(n_valid: int, c: int) -> int:
    """IMADs g1_fixedbase_table needs for n_valid source lanes (an invalid
    lane needs none): (W - 1) c doublings, W - 1 prefix products, one
    inversion (`inv_imads`), and backward W - 1 products for each Z^-1
    and W - 1 to peel Z off, then per window x = X Z^-2, y = Y Z^-3 (3
    products and a squaring). On the setup's points no Z is 0, so nothing
    is skipped."""
    from lambdaworks_kzg_tpu_torch.constants import num_windows

    w = num_windows(c)
    muls = 3 * (w - 1) + 3 * w
    per_lane = (w - 1) * c * op_imads("dbl") + muls * IMAD_PER_FP_MUL + w * IMAD_PER_FP_SQR + inv_imads()
    return n_valid * per_lane

# The tower's least work, in Fp products (a square costs a product's
# IMADs here, as an Fp2 square's two products are not squares of Fp): an
# Fp2 product is 3 Fp products (Karatsuba), a square 2; an Fp6 product 6
# Fp2 products, a square 1 product and 4 squares (Chung-Hasan SQR3); an
# Fp12 product 3 Fp6 products, a square 3 Fp6 squares, a cyclotomic square
# 9 Fp2 squares (Granger-Scott), the product by a sparse line
# ((c0, c2, 0), (0, c3, 0)) 13 Fp2 products (5 + 3 + 5 by Karatsuba over
# w), a Frobenius map by p 5 Fp2 products (gamma_0 = 1) and one by p^2
# 10 Fp products (its constants lie in Fp).
MUL2 = 3 * IMAD_PER_FP_MUL
SQR2 = 2 * IMAD_PER_FP_MUL
MUL6, SQR6 = 6 * MUL2, MUL2 + 4 * SQR2
MUL12, SQR12, CYC12, LINE12 = 3 * MUL6, 3 * SQR6, 9 * SQR2, 13 * MUL2
FROB12, FROB12_P2 = 5 * MUL2, 10 * IMAD_PER_FP_MUL


def fp2_inv_imads() -> int:
    """conj(a) / (a0^2 + a1^2): two squares, an inversion, two products."""
    return 2 * IMAD_PER_FP_SQR + inv_imads() + 2 * IMAD_PER_FP_MUL


def fp12_inv_imads() -> int:
    """(a0 t, -a1 t), t = (a0^2 - v a1^2)^-1: two Fp6 squares, two Fp6
    products, and the Fp6 inversion's 3 Fp2 squares, 9 Fp2 products and
    one Fp2 inversion."""
    return 2 * SQR6 + 2 * MUL6 + 3 * SQR2 + 9 * MUL2 + fp2_inv_imads()


def miller_imads(n_valid: int) -> int:
    """IMADs pairing_miller_loop needs for n_valid pairs (a pair with a
    member at infinity needs none): both affine conversions, then per bit
    of |x| below its top an Fp12 square, a doubling step in homogeneous
    projective coordinates with its line (2 Fp2 products, 7 Fp2 squares,
    2 Fp2-by-Fp products; Aranha et al., Eurocrypt 2011) and the sparse
    line's product, at each set bit a mixed addition step with its line
    (11 Fp2 products, 2 squares, 2 by Fp) and the line's product. f starts
    at one, so the first bit's square and line product are free."""
    x_abs = 0xD201000000010000
    dbl_step = 2 * MUL2 + 7 * SQR2 + 4 * IMAD_PER_FP_MUL
    add_step = 11 * MUL2 + 2 * SQR2 + 4 * IMAD_PER_FP_MUL + LINE12
    bits = bin(x_abs)[3:]
    loop = len(bits) * dbl_step + (len(bits) - 1) * (SQR12 + LINE12) + bits.count("1") * add_step
    affine = (inv_imads() + IMAD_PER_FP_SQR + 3 * IMAD_PER_FP_MUL
              + fp2_inv_imads() + SQR2 + 3 * MUL2)
    return n_valid * (affine + loop)


def final_exp_imads(lanes: int) -> int:
    """IMADs pairing_final_exp needs for B lanes: B - 1 Fp12 products, the
    easy part (an inversion, 2 products, a Frobenius map by p^2), five
    powers by |x| or |x - 1| (per bit below the top a cyclotomic square,
    per set bit below it a product), then Frobenius maps by p and p^2, 5
    products and a cyclotomic square."""
    x_abs, xm1_abs = 0xD201000000010000, 0xD201000000010001

    def pow_abs(e: int) -> int:
        return (e.bit_length() - 1) * CYC12 + (bin(e).count("1") - 1) * MUL12

    easy = fp12_inv_imads() + 2 * MUL12 + FROB12_P2
    hard = 2 * pow_abs(xm1_abs) + 3 * pow_abs(x_abs) + FROB12 + FROB12_P2 + 5 * MUL12 + CYC12
    return (lanes - 1) * MUL12 + easy + hard


# Lane counts of phase 3 for the per-op kernels (and 200, a block and a
# partial one), each holding the exceptional lanes its lane pattern reaches
CHECK_LANES = (1, 2, 4, 8, 16, 32, 64, 128, 200, 256, 512, 1024, 2048, 4096)
# Lane counts of phase 3 for g1_decompress, g1_scalar_mul and
# g1_subgroup_mask (4, 8 or 16 threads a lane, blocks of 64): inside one
# warp, a warp and one lane more or less, blocks; 4096 is checked at the
# conversion's shape
EDGE_LANES = (1, 12, 31, 33, 128)
C_MAIN = 8  # the mainnet path's window bits
PATH_KERNELS = ("g1_bucket_accumulate", "g1_bucket_reduce", "g1_fixedbase_table")
# the generic MSM (JAX's windowed one): its windows' sums, then their
# Horner combine; no table
GENERIC_KERNELS = ("g1_bucket_accumulate", "g1_bucket_reduce", "g1_window_combine")
GENERIC_LAUNCHES = dict.fromkeys(GENERIC_KERNELS, 1)
# phase 3's combines: (window bits, MSMs), windows for 255-bit scalars;
# c = 4 is a batch verification's, 8 and 12 phase 15's
COMBINE_SHAPES = tuple((c, b) for c in (4, 8, 12) for b in (1, 3))
# a batch's Fr part: one evaluation and one quotient on the plain limbs;
# a proof at a root of unity: the in-domain quotient on them; a batch
# verification's blob evaluations
FR_PROOF_LAUNCHES = {"fr_evaluate": 1, "fr_quotient": 1}
FR_ROOT_LAUNCHES = {"fr_quotient_in_domain": 1}
FR_EVAL_LAUNCHES = {"fr_evaluate": 1}
FR_PART_MAX = 6  # device operations of a batch's Fr part under the profiler
FR_KERNELS = ("fr_to_mont", "fr_evaluate", "fr_quotient", "fr_quotient_in_domain")
FR_PATH_KERNELS = FR_KERNELS[1:]  # fr_to_mont is on no path
FR_BLOBS = (1, 6, 64)  # phase 3's batches at the blob domain: a proof, a block, a batch verification
FR_ROOT_SEED = 4847  # phase 3's seeded in-domain index
PROVE_KERNELS = ("g1_bucket_accumulate", "g1_bucket_reduce", *FR_PATH_KERNELS)
MESH_KERNELS = ("g1_bucket_accumulate", "g1_bucket_reduce", "g1_fixedbase_table", "g1_fold",
                "g1_window_combine")
# phase 3's folds: (rows K, lanes B), K = 2, 3, 4 on 12 lanes, then the
# meshes' own (the (2, 2) mesh's rows of 3 blobs, the (1, 4) mesh's 6)
FOLD_SHAPES = ((2, 12), (3, 12), (4, 12), (2, 3), (4, 6))
# one conversion of the mainnet setup (n = 4096): one decompression, one
# subgroup check, 12 FFT stages of one launch each, and [1/n]
CONVERT_LAUNCHES = {"g1_decompress": 1, "g1_subgroup_mask": 1, "g1_fft_stage": 12,
                    "g1_scalar_mul": 1}
FFT_STAGE_LENGTHS = (2, 64, 4096)  # checked in phase 3: first, a middle and last stage
# one pairing check of the device tier: one launch of each pairing kernel
PAIRING_LAUNCHES = {"pairing_miller_loop": 1, "pairing_final_exp": 1}
# one verify_blob_kzg_proof_batch of n >= 2 blobs whose inputs pass the
# checks, on a card: one batched decompression and subgroup check, the
# blob evaluations, one batch of three generic MSMs, one pairing check
VERIFY_BATCH_LAUNCHES = {"g1_decompress": 1, "g1_subgroup_mask": 1, **GENERIC_LAUNCHES,
                         **FR_EVAL_LAUNCHES, **PAIRING_LAUNCHES}
# the same batch on the host pairing tier: no pairing kernel
HOST_TIER = {name: -n for name, n in PAIRING_LAUNCHES.items()}
NTT_N = 4096  # the blob domain
MESH_SHAPES = ((1, 1), (2, 2), (1, 4))  # phase 11's logical meshes, over one card four times
SETUP_4 = os.path.join(HERE, "testdata", "trusted_setup_4.txt")
SRS_4_NAME = "srs_0f1c825ca54c4fef.npz"  # its cache name (not committed)
SRS_MAINNET = os.path.join(HERE, "cache", "srs_mainnet.npz")
CONSENSUS = os.path.join(HERE, "testdata", "consensus")
# the arguments of each entry point as a vector's input names them, and
# how many vectors each has
VECTOR_ARGS = {
    "blob_to_kzg_commitment": ("blob",),
    "compute_kzg_proof": ("blob", "z"),
    "compute_blob_kzg_proof": ("blob", "commitment"),
    "verify_kzg_proof": ("commitment", "z", "y", "proof"),
    "verify_blob_kzg_proof": ("blob", "commitment", "proof"),
    "verify_blob_kzg_proof_batch": ("blobs", "commitments", "proofs"),
}
VERIFY_FNS = ("verify_kzg_proof", "verify_blob_kzg_proof", "verify_blob_kzg_proof_batch")
# phase 8b's vectors run again with the native tier off: 10 of the 140
NATIVE_OFF_VECTORS = {"verify_kzg_proof": 4, "verify_blob_kzg_proof": 3,
                      "verify_blob_kzg_proof_batch": 3}
VECTOR_COUNTS = {"blob_to_kzg_commitment": 10, "compute_kzg_proof": 46, "compute_blob_kzg_proof": 12,
                 "verify_kzg_proof": 93, "verify_blob_kzg_proof": 24,
                 "verify_blob_kzg_proof_batch": 23}
PROOF_VECTOR_CAP = 2  # phase 7's valid proof vectors per function (phase 12 runs all)
# phase 12, the C ABI: every vector of the seven C functions, in this order
CAPI_FNS = ("blob_to_kzg_commitment", "compute_kzg_proof", "compute_blob_kzg_proof",
            "verify_kzg_proof", "verify_blob_kzg_proof", "verify_blob_kzg_proof_batch")
CAPI_VECTOR_COUNT = 208
# the C functions' fixed argument sizes, by the vectors' input names
CAPI_SIZES = {"blob": 131072, "blobs": 131072, "z": 32, "y": 32, "commitment": 48,
              "commitments": 48, "proof": 48, "proofs": 48}
CAPI_KERNELS = ("g1_fixedbase_table", "g1_bucket_accumulate", "g1_bucket_reduce",
                "g1_window_combine", "pairing_miller_loop", "pairing_final_exp", "g1_decompress", "g1_subgroup_mask",
                *FR_PATH_KERNELS)
MSM_LAUNCHES = {"g1_bucket_accumulate": 1, "g1_bucket_reduce": 1}
C_KZG_OK, C_KZG_BADARGS = 0, 1
CAPI_REPS = 5  # timed calls per entry point, through the ABI and on a Python context
NATIVE_REPS = 5  # phase 13's calls per way, in turns
# phase 14: the worlds and the backend each must choose (NCCL refuses two
# ranks on one card), the kernels every world's ranks launch in all
DIST_WORLDS = ((1, "nccl"), (2, "gloo"), (4, "gloo"))
DIST_KERNELS = ("g1_fixedbase_table", "g1_bucket_accumulate", "g1_bucket_reduce", "g1_fold",
                "g1_window_combine", "g1_decompress", "g1_subgroup_mask", "pairing_miller_loop", "pairing_final_exp",
                "fr_evaluate")
DIST_TIMEOUT_S = 240
# phase 15: the generic MSM at the JAX package's bench shapes one card runs
# (n, window bits, scalar bits): bench.py's msm_2e20(_packed248) and
# scripts/bench_msm_sweep.py's 2^16, over the 4096 mainnet Lagrange points tiled
GENERIC_MSM_SHAPES = ((1 << 16, 8, 255), (1 << 20, 12, 255), (1 << 20, 12, 248))
FUZZ_ITERS, FUZZ_SEED = 5, 4844  # phase 16's differential iterations
FUZZ_VECTOR_STRIDE = 16  # phase 16 replays every 16th consensus-vector seed and every generated one
FUZZ_C_TIMEOUT_S = 300
BENCH_REPS, BENCH_TIMEOUT_S = 3, 240  # phase 17's call of the bench
# the bench's path: the degree-4 conversion, commits, proofs, verifications, generic MSMs
BENCH_KERNELS = ("g1_fixedbase_table", "g1_bucket_accumulate", "g1_bucket_reduce", "g1_window_combine",
                 "g1_decompress", "g1_subgroup_mask", "g1_scalar_mul", "g1_fft_stage",
                 "pairing_miller_loop", "pairing_final_exp", "fr_evaluate", "fr_quotient")
CLIENT_SEED = 4849  # kzg_client's blob


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"phase {self.name}: start")
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t0
        log(f"phase {self.name}: {'ok' if exc is None else 'FAILED'} in {dt:.2f} s")
        return False


def make_lanes(points, M: int, seed: int, exceptional: bool = True):
    """Random lanes from the setup's 4096 affine points (radix-2^16 int64
    on the card): p [3, 24, M] Jacobian with Z != 1 on even lanes, q
    [2, 24, M] affine, live bool[M], q3 [3, 24, M]; with `exceptional`,
    every 8 lanes also hold P or Q at infinity, P == Q, P == -Q and a
    dead lane (lanes 1, 2, 3, 5, 6 of each 8)."""
    import torch

    from lambdaworks_kzg_tpu_torch.ops import g1_ops
    from lambdaworks_kzg_tpu_torch.ops.field_ops import FP

    g = torch.Generator().manual_seed(seed)
    n = points.shape[-1]
    pick_p = torch.randint(0, n, (M,), generator=g).to(points.device)
    pick_q = torch.randint(0, n, (M,), generator=g).to(points.device)
    lane = torch.arange(M, device=points.device)
    ones = torch.ones(M, dtype=torch.bool, device=points.device)

    a = g1_ops.lift(points[:, :, pick_p], ones)
    p = torch.where((lane % 2 == 0)[None, None], g1_ops.dbl(a), a)
    q = points[:, :, pick_q].contiguous()
    q_jac = g1_ops.lift(q, ones)
    q3 = torch.where((lane % 2 == 1)[None, None], g1_ops.dbl(q_jac), q_jac)
    if not exceptional:
        return p.contiguous(), q, ones, q3.contiguous()

    def put(arr, mask, value):
        return torch.where(mask[None, None], value, arr)

    neg_q = torch.stack([q_jac[0], FP.neg(q_jac[1]), q_jac[2]])
    p = put(p, lane % 8 == 1, torch.zeros_like(p))  # P at infinity
    p = put(p, lane % 8 == 3, q_jac)  # P == Q
    p = put(p, lane % 8 == 5, neg_q)  # P == -Q
    live = (lane % 8 != 6).contiguous()  # dead lanes
    q3 = put(q3, lane % 8 == 2, torch.zeros_like(q3))  # Q at infinity
    q3 = put(q3, lane % 8 == 3, p)  # same point
    q3 = put(q3, lane % 8 == 5, torch.stack([p[0], FP.neg(p[1]), p[2]]))  # -P
    return p.contiguous(), q, live, q3.contiguous()


def random_blobs(rng, count: int):
    """Seeded blobs of canonical elements (31 random bytes, a zero top)."""
    return [b"".join(rng.bytes(31) + b"\x00" for _ in range(4096)) for _ in range(count)]


def scalar_members(table_valid, scalars, c: int):
    """[B, 16, n] plain scalars -> (order, bstart) as the main path sorts them."""
    import torch

    from lambdaworks_kzg_tpu_torch.ops import msm

    digits = msm.fixedbase_digits(scalars, c)
    return msm.sort_members(torch.where(table_valid, digits, torch.zeros_like(digits)), c)


def blob_members(table_valid, blobs, c: int):
    """Blobs -> (order, bstart) as the main path sorts them."""
    import numpy as np

    from lambdaworks_kzg_tpu_torch.ops import codec, limbs as lb

    scalars = lb.as_limb_tensor(
        np.stack([codec.blob_to_limbs(b, 4096) for b in blobs]), table_valid.device)
    return scalar_members(table_valid, scalars, c)


def skewed_blobs() -> dict:
    """Blobs whose digits crowd into one bucket: 4096 elements 0x0101..01
    (every 8-bit digit 1: all 131,072 members in bucket 1) and 4096 ones
    (window 0's 4096 members in bucket 1, the rest in bucket 0)."""
    return {"0x0101..01": bytes([1]) * 32 * 4096,
            "ones": (1).to_bytes(32, "little") * 4096}


def dense_blob(rng) -> bytes:
    """A blob of elements uniform below r (seeded random.Random)."""
    from lambdaworks_kzg_tpu_torch.constants import R

    return b"".join(rng.randrange(R).to_bytes(32, "little") for _ in range(4096))


def basis_affine(setup):
    """The setup's Lagrange basis as host affine points (None at infinity)."""
    from lambdaworks_kzg_tpu_torch.ops.field_ops import FP

    xs, ys = (FP.from_mont_host(setup.lagrange_points[k]) for k in range(2))
    return [(x, y) if v else None for x, y, v in zip(xs, ys, setup.lagrange_valid)]


def check_real_quotient(setup, table16, table_valid, max_err: dict):
    """The quotient of a dense seeded blob at a seeded z, computed on the
    card, equals the host quotient; both MSM kernels equal their plain
    versions on its members, and the MSM of it on the kernels equals the
    host oracle g1_msm in affine form -> (order, bstart) of its members."""
    import torch

    from lambdaworks_kzg_tpu_torch.constants import R
    from lambdaworks_kzg_tpu_torch.host import curve as HC, fft
    from lambdaworks_kzg_tpu_torch.ops import codec, dispatch, fr_poly, limbs as lb, msm

    dev, n = table16.device, setup.n
    rng = random.Random(7)
    blob, z = dense_blob(rng), rng.randrange(R)
    evals = [int.from_bytes(blob[32 * i : 32 * i + 32], "little") for i in range(n)]
    domain = fr_poly.FrDomain(n, dev)
    q, y_dev = domain.open_mont(lb.as_limb_tensor(codec.blob_to_limbs(blob, n), dev)[None], [z])
    y = fft.barycentric_evaluate(evals, z, n)
    q_host = fft.quotient(evals, z, y, n)
    if lb.limbs_to_ints(y_dev[0]) != [y] or lb.limbs_to_ints(q[0]) != q_host:
        raise AssertionError("the card's evaluation or quotient differs from the host's")
    order, bstart = scalar_members(table_valid, q, C_MAIN)
    top = int(msm.window_digits(q, C_MAIN)[0, -1].max())
    log(f"  real quotient: y and q equal to the host's; top window digits up to {top:#x}")
    check_msm_kernels(f"real quotient c={C_MAIN} B=1", table16, order, bstart, C_MAIN, max_err)
    point = msm.msm_fixedbase(dispatch.to_table_layout(table16), table_valid, q[0], C_MAIN)
    t0 = time.perf_counter()
    want = HC.g1_msm(q_host, basis_affine(setup))
    if HC.to_affine(point) != HC.to_affine(want):
        raise AssertionError("the kernels' MSM of the quotient differs from the host g1_msm")
    log(f"  real quotient: the kernels' MSM equals the host g1_msm in affine form "
        f"({time.perf_counter() - t0:.1f} s on the host)")
    return order, bstart


def launch_counts() -> dict:
    """Each kernel's launch count, by name."""
    from lambdaworks_kzg_tpu_torch.ops import kernels

    return kernels.counts()


def check_verify_batch_launches(what: str, before: dict, extra=None) -> None:
    """One verify_blob_kzg_proof_batch of n >= 2 blobs that passed its input
    checks made VERIFY_BATCH_LAUNCHES (and `extra`) and nothing else."""
    delta = {name: n - before[name] for name, n in launch_counts().items()}
    want = {name: VERIFY_BATCH_LAUNCHES.get(name, 0) + (extra or {}).get(name, 0)
            for name in delta}
    if delta != want:
        raise AssertionError(f"{what}: launches {delta}, not {want}")


def run_vectors(ctx, fn: str, extra=None, device_checks=None, valid_cap=None) -> int:
    """Every consensus vector of one entry point through ctx, or with
    `valid_cap` every one whose output is null and the first `valid_cap`
    others; a KZGError stands for the vector's null output. Raises unless
    all agree. A
    verify_blob_kzg_proof_batch vector of n >= 2 blobs with a verdict
    must launch VERIFY_BATCH_LAUNCHES, and `extra` beside them; with
    `device_checks` (the count of device-tier pairing checks so far), every
    vector must launch each pairing kernel once per check it made."""
    from lambdaworks_kzg_tpu_torch import KZGError
    from lambdaworks_kzg_tpu_torch.utils.yaml_vectors import load_case

    names = sorted(os.listdir(os.path.join(CONSENSUS, fn, "small")))
    t0, wrong, counted_batches, ran, valid = time.perf_counter(), [], 0, 0, 0
    for name in names:
        case = load_case(os.path.join(CONSENSUS, fn, "small", name, "data.yaml"))
        if case["output"] is not None:
            valid += 1
            if valid_cap is not None and valid > valid_cap:
                continue
        ran += 1
        before = launch_counts()
        checks_before = device_checks() if device_checks else 0
        try:
            got = getattr(ctx, fn)(*(case["input"][a] for a in VECTOR_ARGS[fn]))
        except KZGError:
            got = None
        if device_checks is not None:
            checks = device_checks() - checks_before
            after = launch_counts()
            if any(after[k] - before[k] != n * checks for k, n in PAIRING_LAUNCHES.items()):
                raise AssertionError(f"{name}: {checks} device pairing checks launched "
                                     f"{ {k: after[k] - before[k] for k in PAIRING_LAUNCHES} }")
        if (fn == "verify_blob_kzg_proof_batch" and case["output"] is not None
                and len(case["input"]["blobs"]) >= 2):
            check_verify_batch_launches(name, before, extra)
            counted_batches += 1
        if isinstance(got, tuple):
            got = list(got)
        if got != case["output"] or type(got) is not type(case["output"]):
            wrong.append(name)
    dt = time.perf_counter() - t0
    log(f"  {fn}: {ran - len(wrong)}/{ran} correct in {dt:.2f} s "
        f"({dt / ran * 1e3:.1f} ms per vector)"
        + (f" (every null-output vector and the first {valid_cap} of {valid} others, of "
           f"{len(names)})" if ran < len(names) else "")
        + (f"; {counted_batches} batches of n >= 2 launched {VERIFY_BATCH_LAUNCHES} each"
           if counted_batches else ""))
    if wrong or len(names) != VECTOR_COUNTS[fn]:
        raise AssertionError(f"{fn}: wrong on {wrong} ({len(names)} vectors)")
    return ran


@contextlib.contextmanager
def native_off():
    """LWKZG_NATIVE=0 for the block: the native tier off, as a user turns
    it off."""
    old = os.environ.get("LWKZG_NATIVE")
    os.environ["LWKZG_NATIVE"] = "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["LWKZG_NATIVE"]
        else:
            os.environ["LWKZG_NATIVE"] = old


def run_vector_subset(ctx, counts: dict) -> int:
    """counts[fn] vectors of each verify function through ctx, each
    verdict or KZGError as the vector has it: by name, the first null
    one, and of the others the first half true and the rest false ->
    the pairing checks they make (one per verdict but the empty batch's)."""
    from lambdaworks_kzg_tpu_torch import KZGError
    from lambdaworks_kzg_tpu_torch.utils.yaml_vectors import load_case

    checks = 0
    for fn, count in counts.items():
        cases = [(name, load_case(os.path.join(CONSENSUS, fn, "small", name, "data.yaml")))
                 for name in sorted(os.listdir(os.path.join(CONSENSUS, fn, "small")))]
        by_output = {out: [c for c in cases if c[1]["output"] is out] for out in (None, True, False)}
        k = count - 1
        picked = by_output[None][:1] + by_output[True][:(k + 1) // 2] + by_output[False][:k // 2]
        for name, case in picked:
            args = [case["input"][a] for a in VECTOR_ARGS[fn]]
            try:
                got = getattr(ctx, fn)(*args)
            except KZGError:
                got = None
            if got is not case["output"]:
                raise AssertionError(f"{name}: {got}, not {case['output']}")
            checks += got is not None and not (fn == "verify_blob_kzg_proof_batch" and not args[0])
    return checks


def timed_call(fn, *args, want=MSM_LAUNCHES):
    """fn(*args) between two CUDA events -> (result, ms); raises unless the
    call launched exactly `want` (each MSM kernel once, and a proof's Fr
    kernels), nothing else."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    before = launch_counts()
    start.record()
    out = fn(*args)
    end.record()
    torch.cuda.synchronize()
    expect_launches("one call", before, want)
    return out, start.elapsed_time(end)


def host_syncs(fn) -> int:
    """How many times fn() makes the host wait for the card: the
    synchronizing calls PyTorch's sync debug mode reports (transfers to
    and from pageable host memory, synchronize)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def prove_split(backend, blobs, zs) -> dict:
    """One batch's Fr part as TorchBackend.open_scalars runs it
    (`FrDomain.open_mont`: the z table's transfer, the evaluation and the
    quotient on the plain limbs, one launch each of fr_evaluate and
    fr_quotient, checked), then its MSM with the proofs' transfer to the
    host, each between CUDA events, and each once more under the profiler
    for its launches: the Fr part's record must hold both kernels of
    FR_PROOF_LAUNCHES and the table's copy, and at most FR_PART_MAX
    launches."""
    import torch

    domain = backend.domain
    scalars = backend.blob_scalars(blobs)

    def fr():
        return domain.open_mont(scalars, zs)[0]

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    before = launch_counts()
    ev[0].record()
    q = fr()
    ev[1].record()
    expect_launches(f"the Fr part of {len(blobs)} proofs", before, FR_PROOF_LAUNCHES)
    backend.commit_scalars(q)
    ev[2].record()
    torch.cuda.synchronize()
    out = {
        "blobs": len(blobs),
        "fr_ms": ev[0].elapsed_time(ev[1]),
        "msm_ms": ev[1].elapsed_time(ev[2]),
        "fr_device": device_work(fr),
        "msm_device": device_work(lambda: backend.commit_scalars(q)),
    }
    fr_dev = out["fr_device"] or {"kernels": 0, "copies": 0, "names": []}
    seen = [name for name in FR_PROOF_LAUNCHES if any(name in key for key in fr_dev["names"])]
    if seen != list(FR_PROOF_LAUNCHES) or fr_dev["copies"] < 1 or fr_dev["kernels"] > FR_PART_MAX:
        raise AssertionError(f"the profiler's record of the Fr part of {len(blobs)} proofs lacks a kernel "
                             f"or the copy, or holds more than {FR_PART_MAX} launches: {fr_dev}")
    return out


def root_split(backend, blob: bytes, m: int) -> dict:
    """The Fr part of a proof at z = w_m as TorchBackend._open_in_domain
    runs it (`FrDomain.quotient`: the root table's transfer and one
    fr_quotient_in_domain launch on the blob's plain limbs, checked),
    between CUDA events, and once more under the profiler, whose record
    must hold the kernel and the table's copy and at most FR_PART_MAX
    launches."""
    import torch

    domain = backend.domain
    plain = backend.blob_scalars([blob])[0]
    z = domain.roots_brp_ints[m]

    def fr():
        return domain.quotient(plain, z, None)

    torch.cuda.synchronize()
    before = launch_counts()
    _, ms = events_ms(fr)
    expect_launches("the Fr part of a proof at a root", before, FR_ROOT_LAUNCHES)
    out = {"m": m, "fr_ms": ms, "fr_device": device_work(fr)}
    rec = out["fr_device"] or {"kernels": 0, "copies": 0, "names": []}
    if (not any("fr_quotient_in_domain" in key for key in rec["names"]) or rec["copies"] < 1
            or rec["kernels"] > FR_PART_MAX):
        raise AssertionError(f"the profiler's record of the Fr part at a root lacks the kernel or the "
                             f"copy, or holds more than {FR_PART_MAX} launches: {rec}")
    return out


def synthetic_table(points, n_rows: int, c: int, n_blobs: int, seed: int):
    """A table whose rows repeat four setup points and their negations, and
    members sorted by seeded digits in which bucket 1 stays empty and
    bucket 0 (dead) is full -> (table [2, 24, n_rows], order, bstart)."""
    import torch

    from lambdaworks_kzg_tpu_torch.ops import msm
    from lambdaworks_kzg_tpu_torch.ops.field_ops import FP

    pool = points[:, :, :4]
    pool = torch.cat([pool, torch.stack([pool[0], FP.neg(pool[1])])], dim=-1)
    table = pool[:, :, torch.arange(n_rows, device=points.device) % 8].contiguous()
    g = torch.Generator().manual_seed(seed)
    digits = torch.randint(0, 1 << c, (n_blobs, n_rows), generator=g)
    digits = torch.where(digits == 1, torch.zeros_like(digits), digits)
    perm = torch.stack([torch.randperm(n_rows, generator=g) for _ in range(n_blobs)])
    order, bstart = msm.sort_members(digits.to(points.device), c)
    order = torch.gather(perm.to(points.device).to(order.dtype), 1, order.long())
    return table, order, bstart


def synthetic_partials(points, bstart, n_members: int, c: int, chunk: int, seed: int):
    """[3, 24, B K] Jacobian chunk partials: setup points, Z != 1 on every
    third slot; in buckets of several chunks, chunk 0 at infinity, or
    chunk 1 equal or opposite to chunk 0 (the merge doubles or cancels);
    of two one-chunk buckets j and j + 2^(c-1), the first at infinity, or
    the second equal or opposite to it (the fold's cases)."""
    import torch

    from lambdaworks_kzg_tpu_torch.ops import g1_ops
    from lambdaworks_kzg_tpu_torch.ops.field_ops import FP

    first, _ = g1_ops.chunk_plan(bstart.cpu(), n_members, chunk)
    slots = g1_ops.chunk_slots(n_members, c, chunk)
    m = bstart.shape[0] * slots
    g = torch.Generator().manual_seed(seed)
    pts = points.cpu()[:, :, torch.randint(0, points.shape[-1], (m,), generator=g)]
    bk = g1_ops.lift(pts, torch.ones(m, dtype=torch.bool))
    bk = torch.where((torch.arange(m) % 3 == 0)[None, None], g1_ops.dbl(bk), bk)
    h = 1 << (c - 1)
    for b in range(bstart.shape[0]):
        f = [b * slots + int(x) for x in first[b]]
        for j in range(1, 1 << c):
            s0, n = f[j], f[j + 1] - f[j]
            if n == 1 and j < h and f[j + h + 1] - f[j + h] == 1:
                s1 = f[j + h]
            elif n >= 2:
                s1 = s0 + 1
            else:
                continue
            if j % 3 == 0:
                bk[:, :, s0] = 0
            else:
                bk[:, :, s1] = bk[:, :, s0]
                if j % 3 == 2:
                    bk[1, :, s1] = FP.neg(bk[1, :, s0 : s0 + 1])[:, 0]
    return bk.to(points.device)


def same(name: str, got16, want16) -> int:
    """Raise unless kernel and plain agree limb for limb -> max |limb error|."""
    import torch

    torch.cuda.synchronize()
    if not torch.equal(got16, want16):
        bad = int((got16 != want16).any(dim=0).any(dim=0).sum().item())
        raise AssertionError(f"{name}: kernel differs from plain on {bad} lanes")
    return int((got16 - want16).abs().max()) if got16.numel() else 0


def check_msm_kernels(label: str, table16, order, bstart, c: int, max_err: dict,
                      extra_partials=None) -> None:
    """Both MSM kernels against their plain versions on the same inputs,
    at the path's chunk length: the accumulation, then the reduce of its
    partials (and of `extra_partials`); max_err[name] keeps each kernel's
    max |limb error|."""
    from lambdaworks_kzg_tpu_torch.ops import dispatch, g1_ops, kernels, limbs as lb

    def check(name: str, what: str, got16, want16) -> None:
        max_err[name] = max(max_err[name], same(f"{name} {what}", got16, want16))
        log(f"  {name} {what}: equal to plain, limb for limb")

    n_members = order.shape[1]
    chunk = chunk_length(*order.shape)
    rows = dispatch.to_table_layout(table16)
    plain = g1_ops.accumulate_chunks(table16, order, bstart, c, chunk)
    got = kernels.bucket_accumulate(rows, order, bstart, c, chunk)
    check("g1_bucket_accumulate", f"{label} (L = {chunk})", dispatch.from_table_layout(got), plain)
    for what, partials in (("its partials", plain), ("synthetic partials", extra_partials)):
        if partials is None:
            continue
        got = kernels.bucket_reduce(dispatch.to_table_layout(partials), bstart, c, chunk, n_members)
        check("g1_bucket_reduce", f"{label}, {what}", lb.to_u16_layout(got),
              g1_ops.reduce_chunks(partials, bstart, c, chunk, n_members))


def combine_sums(points, c: int, msms: int, seed: int, special: bool):
    """Window sums [3, 24, B W] (W = num_windows(c, 255)) of B = msms
    MSMs, Z != 1 on every other lane. special (B = 3): the combine's edge
    sums (utils.combine_cases.combine_edge_sums: a window and
    a whole run at infinity, Horner, comb and last adds of equal and of
    opposite points); else from the setup's points, every window finite.
    -> (sums, W)."""
    import torch

    from lambdaworks_kzg_tpu_torch.constants import num_windows
    from lambdaworks_kzg_tpu_torch.ops import g1_ops
    from lambdaworks_kzg_tpu_torch.utils import combine_cases

    w = num_windows(c, 255)
    if special:
        return combine_cases.combine_edge_sums(c, w, seed, points.device), w
    lanes = msms * w
    g = torch.Generator().manual_seed(seed)
    pick = torch.randint(0, points.shape[-1], (lanes,), generator=g).to(points.device)
    jac = g1_ops.lift(points[:, :, pick], torch.ones(lanes, dtype=torch.bool, device=points.device))
    jac = torch.where((torch.arange(lanes, device=points.device) % 2 == 0)[None, None],
                      g1_ops.dbl(jac), jac)
    return jac.contiguous(), w


def combine_chain(c: int, w: int) -> dict:
    """The combine's critical path on its runs (g1_ops.combine_runs): the
    top run's c (W - 1) doublings (3 products deep on four groups) and its
    Horner adds, then the last add (5 deep each); beside it Horner's on a
    pair of groups (4 and 8 deep), the kernel before."""
    from lambdaworks_kzg_tpu_torch.ops import g1_ops

    starts = g1_ops.combine_runs(w, c)
    adds = w - starts[-1] - 1 + (len(starts) > 1)
    return {"runs": [b - a for a, b in zip(starts, starts[1:] + [w])], "dbl": c * (w - 1),
            "add": adds, "products_deep": 3 * c * (w - 1) + 5 * adds,
            "horner_products_deep": 4 * c * (w - 1) + 8 * (w - 1)}


def check_window_combine(points, max_err: dict) -> dict:
    """g1_window_combine against g1_ops.combine_windows on the card, limb
    for limb, at COMBINE_SHAPES: one MSM on finite sums, three on
    `combine_sums`' special ones; each shape's kernel timed (CUDA events)
    on finite sums beside the plain version's one call (the checked one)
    and the bound of its c (W - 1) doublings and W - 1 adds a MSM (the
    function's fewest point ops); its critical path (`combine_chain`)
    logged. -> {"c{c}_b{B}": ...}."""
    import torch

    from lambdaworks_kzg_tpu_torch.ops import dispatch, g1_ops, kernels, limbs as lb

    out = {}
    for c, msms in COMBINE_SHAPES:
        label = f"c={c} B={msms}"
        sums, w = combine_sums(points, c, msms, seed=10 * c + msms, special=msms > 1)
        sums32 = lb.to_u32_layout(sums)
        got = kernels.window_combine(sums32, c, w)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = g1_ops.combine_windows(sums, c, w)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        max_err["g1_window_combine"] = max(max_err["g1_window_combine"],
                                           same(f"g1_window_combine {label}", lb.to_u16_layout(got),
                                                want))
        if not torch.equal(dispatch.combine_windows(sums32, c, w), got):
            raise AssertionError(f"g1_window_combine {label}: dispatch's route differs")
        if msms > 1:  # timed on finite sums, as every shape is
            sums32 = lb.to_u32_layout(combine_sums(points, c, msms, seed=c, special=False)[0])
        ms = time_ms(lambda: kernels.window_combine(sums32, c, w), reps=10)
        nbytes = msms * (w + 1) * 3 * FP_BYTES
        imads = msms * (w - 1) * (c * op_imads("dbl") + op_imads("add"))
        chain = combine_chain(c, w)
        out[f"c{c}_b{msms}"] = {"c": c, "msms": msms, "windows": w, "ms": ms,
                                "plain_ms": plain_ms, **bound(nbytes, imads), "chain": chain}
        log(f"  g1_window_combine {label} (W = {w}; runs of {chain['runs']} windows; "
            f"critical path {chain['dbl']} doublings and {chain['add']} adds, "
            f"{chain['products_deep']} products deep, Horner's {chain['horner_products_deep']}): "
            f"equal to plain, limb for limb, on {'edge' if msms > 1 else 'finite'} sums; kernel "
            f"{ms:.4f} ms on finite sums, plain {plain_ms:.1f} ms, bound "
            f"{out[f'c{c}_b{msms}']['bound_ms']:.6f} ms (operations)")
    return out


MSM_STAGE_KERNELS = {"accumulate": "g1_bucket_accumulate", "reduce": "g1_bucket_reduce",
                     "combine": "g1_window_combine"}


def msm_stages(fn) -> dict:
    """fn(), one generic MSM (`msm.msm_device`), under the profiler
    (`device_work`) -> its device time in ms by stage: "accumulate",
    "reduce" and "combine" the three MSM kernels' own, "sort" that of
    every other kernel and copy of the call (the scalar check, digits,
    sort, run bounds, the points' rows). Device time only: the host's
    launches between them are in the call's CUDA-event ms."""
    work = device_work(fn)
    if work is None:
        raise AssertionError("the profiler saw no device work in a generic MSM")
    out = dict.fromkeys(("sort", *MSM_STAGE_KERNELS), 0.0)
    for name, ms in work["ms_by_name"].items():
        out[next((s for s, k in MSM_STAGE_KERNELS.items() if k in name), "sort")] += ms
    missing = [k for s, k in MSM_STAGE_KERNELS.items() if not out[s]]
    if missing:
        raise AssertionError(f"the profiler's record of a generic MSM lacks {missing}")
    return out


def accumulate_point_ops(order, bstart):
    """(madds, lifts) that g1_bucket_accumulate needs for these members:
    each member outside bucket 0 is one step of its chunk, and the first
    step of each chunk lifts the point (no products). A run of members
    never returns a chunk to infinity (P + -P) on these blobs, so no other
    step is free."""
    from lambdaworks_kzg_tpu_torch.ops import g1_ops

    first, bend = g1_ops.chunk_plan(bstart, order.shape[1], chunk_length(*order.shape))
    live = int((bend - bstart.long())[:, 1:].sum())
    lifts = int(first[:, -1].sum())
    return live - lifts, lifts


def reduce_point_ops(bstart, n_members: int, buckets16, c: int):
    """(adds, doublings) that g1_bucket_reduce needs: the merge's adds
    (each bucket of k chunks k - 1, all of finite points on these blobs),
    then fold_reduce's schedule (fold, tree of each high half, Horner
    chain) run on which merged buckets [3, 24, B 2^c] are at infinity. An
    add with an operand at infinity, and a doubling of infinity, need no
    products; a sum of finite points is counted finite (on these blobs
    none cancels)."""
    from lambdaworks_kzg_tpu_torch.ops import g1_ops
    from lambdaworks_kzg_tpu_torch.ops.field_ops import FP

    first, _ = g1_ops.chunk_plan(bstart, n_members, chunk_length(bstart.shape[0], n_members))
    chunks = first[:, 1:] - first[:, :-1]
    counts = {"adds": int((chunks - 1).clamp(min=0).sum()), "dbls": 0}
    nb = 1 << c
    finite = ~FP.is_zero(buckets16[2])
    finite = finite.reshape(-1, nb).clone()
    finite[:, 0] = False  # bucket 0 has weight 0

    def add(a, b):
        counts["adds"] += int((a & b).sum())
        return a | b

    def tree(x):
        while x.shape[-1] > 1:
            half = x.shape[-1] // 2
            x = add(x[..., :half], x[..., half:])
        return x[..., 0]

    totals, arr, h = [], finite, nb // 2
    while h >= 1:
        totals.append(tree(arr[:, h : 2 * h]))
        arr = add(arr[:, :h], arr[:, h : 2 * h])
        h //= 2
    acc = totals[0]
    for e in totals[1:]:
        counts["dbls"] += int(acc.sum())
        acc = add(acc, e)
    return counts["adds"], counts["dbls"]


def check_table(label: str, points16, valid, c: int):
    """g1_fixedbase_table against g1_ops.fixedbase_table on the same basis,
    limb for limb -> (max |limb error|, kernel ms, plain ms), one call of
    each timed with CUDA events."""
    import torch

    from lambdaworks_kzg_tpu_torch.constants import num_windows
    from lambdaworks_kzg_tpu_torch.ops import dispatch, g1_ops, kernels, limbs as lb, msm

    points32 = lb.to_u32_layout(points16)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    rows = kernels.fixedbase_table(points32, valid, c)
    end.record()
    torch.cuda.synchronize()
    kernel_ms = start.elapsed_time(end)
    start.record()
    want, want_valid = msm.build_fixedbase_tables(points16, valid, c, ops=g1_ops)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    err = same(f"g1_fixedbase_table {label}", dispatch.from_table_layout(rows), want)
    if not torch.equal(want_valid, valid.repeat(num_windows(c))):
        raise AssertionError(f"g1_fixedbase_table {label}: plain valid mask is not the basis' repeated")
    log(f"  g1_fixedbase_table {label}: equal to plain, limb for limb "
        f"(kernel {kernel_ms:.3f} ms, plain {plain_ms:.1f} ms)")
    return err, kernel_ms, plain_ms


def check_sqr(dev, count: int, seed: int) -> None:
    """fp::sqr against fp::mul(a, a) and the plain square FP.sqr, on 0, 1,
    p - 1, R mod p (Montgomery one) and seeded random elements."""
    from lambdaworks_kzg_tpu_torch.constants import P
    from lambdaworks_kzg_tpu_torch.ops import kernels, limbs as lb
    from lambdaworks_kzg_tpu_torch.ops.field_ops import FP

    rng = random.Random(seed)
    values = [0, 1, P - 1, (1 << 384) % P] + [rng.randrange(P) for _ in range(count - 4)]
    a = lb.to_u32_layout(lb.as_limb_tensor(lb.ints_to_limbs(values, 24), dev))
    sq, mm = kernels.sqr_check(a)
    same("fp::sqr against fp::mul(a, a)", sq, mm)
    same("fp::sqr against FP.sqr", lb.to_u16_layout(sq), FP.sqr(lb.to_u16_layout(a)))
    log(f"  fp::sqr M={count}: equal to fp::mul(a, a) and to the plain square")


def check_coop(dev, count: int, seed: int) -> int:
    """The cooperative field (fp_coop.cuh, through fp_coop_check) against
    fp::mul, fp::sqr and the plain sum, difference, zero test and equality,
    on all pairs of 0, 1, p - 1, p - 2, 2, R mod p and seeded random
    elements -> max |limb error|."""
    import torch

    from lambdaworks_kzg_tpu_torch.constants import P
    from lambdaworks_kzg_tpu_torch.ops import kernels, limbs as lb
    from lambdaworks_kzg_tpu_torch.ops.field_ops import FP

    rng = random.Random(seed)
    edge = [0, 1, P - 1, P - 2, 2, (1 << 384) % P]
    pairs = [(x, y) for x in edge for y in edge]
    pairs += [(rng.randrange(P), rng.randrange(P)) for _ in range(count - len(pairs))]
    a16, b16 = (lb.as_limb_tensor(lb.ints_to_limbs(v, 24), dev) for v in zip(*pairs))
    out = kernels.coop_check(lb.to_u32_layout(a16), lb.to_u32_layout(b16))
    err = max(same("fpc::mul against fp::mul", out[0], out[4]),
              same("fpc::sqr against fp::sqr", out[1], out[5]),
              same("fpc::mul against FP.mul", lb.to_u16_layout(out[0]), FP.mul(a16, b16)),
              same("fpc::add against FP.add", lb.to_u16_layout(out[2]), FP.add(a16, b16)),
              same("fpc::sub against FP.sub", lb.to_u16_layout(out[3]), FP.sub(a16, b16)))
    if (out[6, 0].tolist() != [int(x == 0) for x, _ in pairs]
            or out[6, 1].tolist() != [int(x == y) for x, y in pairs]):
        raise AssertionError("fpc::is_zero or fpc::eq differs from the host")
    log(f"  fp_coop_check M={count}: the cooperative mul, sqr, add, sub, is_zero and eq equal "
        "fp.cuh's and the plain field's")
    return err


def check_kernel(op: str, args16) -> int:
    """Kernel vs plain version on the same inputs, limb for limb -> max
    |limb error|."""
    import torch

    from lambdaworks_kzg_tpu_torch.ops import g1_ops, kernels, limbs as lb

    plain = getattr(g1_ops, op)(*args16)
    k_args = [lb.to_u32_layout(a) if a.dtype == torch.int64 else a for a in args16]
    return same(op, lb.to_u16_layout(getattr(kernels, op)(*k_args)), plain)


def check_fold(points, max_err: dict) -> dict:
    """g1_fold against g1_ops.fold on the card, limb for limb, at each of
    FOLD_SHAPES: K rows of B lanes from make_lanes (Z != 1 on even lanes,
    points at infinity, P == Q and P == -Q among them), row 1 equal to row 0
    on the first lane (the doubling) and its negation on the last
    (infinity); then at each shape on random finite lanes timed (CUDA
    events behind a spin, 200 launches, twice), the plain version once,
    and its bound: K rows in and one out of 144 bytes a lane, K - 1 adds a
    lane -> {"k<K>_b<B>": {"rows", "lanes", "ms", "plain_ms", "bound_ms",
    "bound_by"}}."""
    import torch

    from lambdaworks_kzg_tpu_torch.ops import g1_ops, kernels
    from lambdaworks_kzg_tpu_torch.ops.field_ops import FP

    out = {}
    for rows_k, lanes in FOLD_SHAPES:
        def rows_of(exceptional: bool):
            p, _, _, _ = make_lanes(points, rows_k * lanes, seed=100 * rows_k + lanes, exceptional=exceptional)
            return p.reshape(3, 24, rows_k, lanes).permute(2, 0, 1, 3).contiguous()

        rows = rows_of(True)
        rows[1, :, :, :1] = rows[0, :, :, :1]
        rows[1, :, :, -1:] = torch.stack([rows[0, 0, :, -1:], FP.neg(rows[0, 1, :, -1:]), rows[0, 2, :, -1:]])
        max_err["g1_fold"] = max(max_err["g1_fold"], same(f"g1_fold K={rows_k} B={lanes}",
                                                          kernels.fold(rows), g1_ops.fold(rows)))
        rows = rows_of(False)
        shape = {"rows": rows_k, "lanes": lanes,
                 "ms": sum(time_ms(lambda: kernels.fold(rows), reps=200, warm=5) for _ in range(2)) / 2,
                 "plain_ms": time_ms(lambda: g1_ops.fold(rows), reps=1, warm=1),
                 **bound(lanes * (rows_k + 1) * 3 * FP_BYTES, lanes * (rows_k - 1) * op_imads("add"))}
        out[f"k{rows_k}_b{lanes}"] = shape
        log(f"  g1_fold K={rows_k} B={lanes}: equal to plain, limb for limb; kernel {shape['ms']:.4f} ms, "
            f"plain {shape['plain_ms']:.1f} ms, bound {shape['bound_ms']:.6f} ms ({shape['bound_by']})")
    return out


def outside_g1(count: int):
    """Affine curve points outside G1, scanning x up from 2."""
    from lambdaworks_kzg_tpu_torch.constants import P
    from lambdaworks_kzg_tpu_torch.host import curve as HC
    from lambdaworks_kzg_tpu_torch.host.field import fp_sqrt

    out, x = [], 2
    while len(out) < count:
        y = fp_sqrt((x * x % P * x + 4) % P)
        if y is not None and not HC.g1_in_subgroup((x, y, 1)):
            out.append((x, y))
        x += 1
    return out


def monomial_lanes(setup, n: int, dev, seed: int):
    """[3, 24, n] Jacobian lanes from the setup's monomial G1 powers: Z != 1
    on every third lane (one doubling), every 64th lane at infinity and
    lanes 3, 67, 131 .. (every 64th from 3, up to 16 of them) outside G1
    -> (lanes, host Jacobians, finite bool list)."""
    import torch

    from lambdaworks_kzg_tpu_torch.ops import g1_ops, limbs as lb

    pts = list(setup.g1_monomial[:n])
    bad = outside_g1(16)
    for j, i in enumerate(range(3, n, 64)):
        pts[i] = bad[j % 16]
    for i in range(0, n, 64):
        pts[i] = None
    aff, valid = g1_ops.make_points_host(pts)
    jac = g1_ops.lift(lb.as_limb_tensor(aff, dev), torch.from_numpy(valid).to(dev))
    lane = torch.arange(n, device=dev)
    g = torch.Generator().manual_seed(seed)
    perm = torch.randperm(n, generator=g).to(dev)
    jac = torch.where((lane % 3 == 1)[None, None], g1_ops.dbl(jac), jac)[:, :, perm].contiguous()
    return jac, [pts[i] is not None for i in perm.tolist()]


def fft_stage_lanes(jac, length: int, split16, seed: int):
    """jac [3, 24, n] made ready for one FFT stage of length l with its
    split twiddles [16, n/2]: on every 16th butterfly whose twiddle is 1,
    odd = even, and on 8 seeded butterflies even = [w_j]odd by the plain
    split schedule, so t == even there (the add's doubling, and infinity
    for even - t)."""
    import torch

    from lambdaworks_kzg_tpu_torch.ops import g1_ops

    n, half = jac.shape[-1], length // 2
    a = jac.clone()
    for j in range(0, n // 2, 16 * half):
        e = (j // half) * length
        a[:, :, e + half] = a[:, :, e]
    js = random.Random(seed).sample(range(n // 2), 8)
    even = torch.tensor([(j // half) * length + j % half for j in js], device=a.device)
    a[:, :, even] = g1_ops.scalar_mul_endo(a[:, :, even + half], split16[:, js])
    return a.contiguous()


def check_batch_kernels(setup, dev, max_err: dict) -> dict:
    """g1_decompress, g1_scalar_mul (both modes), g1_fft_stage and
    g1_subgroup_mask against their plain versions on the card, limb for
    limb, at the conversion's shapes and at the lane counts EDGE_LANES ->
    the plain versions' ms (CUDA events) at the shapes phase 10 times the
    kernels at: g1_scalar_mul at 2048 lanes in the general mode (255-bit
    scalars) and in the split mode (an FFT stage's twiddles), and on [1/n]
    at 4096 lanes; g1_fft_stage at each of FFT_STAGE_LENGTHS."""
    import torch

    from lambdaworks_kzg_tpu_torch.constants import P, R
    from lambdaworks_kzg_tpu_torch.host import curve as HC
    from lambdaworks_kzg_tpu_torch.host.field import fp_sqrt
    from lambdaworks_kzg_tpu_torch.ops import g1_batch, g1_ops, kernels, limbs as lb
    from lambdaworks_kzg_tpu_torch.ops.field_ops import FP

    def check(kernel, what, got16, want16):
        max_err[kernel.name] = max(max_err[kernel.name], same(f"{kernel.name} {what}", got16, want16))
        log(f"  {kernel.name} {what}: equal to plain, limb for limb")

    # g1_decompress: the 4096 monomial x's, then 0, 1, p - 1, p - 2, a
    # non-square, x's of points outside G1; seeded sign bits
    non_square = [x for x in range(1, 200) if fp_sqrt((x ** 3 + 4) % P) is None][:4]
    xs = [pt[0] for pt in setup.g1_monomial] + [0, 1, P - 1, P - 2] + non_square
    xs += [pt[0] for pt in outside_g1(4)]
    x16 = lb.as_limb_tensor(FP.to_mont_host(xs), dev)
    want = torch.rand(len(xs), generator=torch.Generator().manual_seed(1)).to(dev) < 0.5
    y, qr = kernels.decompress(lb.to_u32_layout(x16), want)
    y_plain, qr_plain = g1_ops.decompress_xy(x16, want)
    check(kernels.decompress, f"M={len(xs)} (y)", lb.to_u16_layout(y), y_plain)
    check(kernels.decompress, f"M={len(xs)} (square test)", qr.long(), qr_plain.long())
    expect_qr = [fp_sqrt((x ** 3 + 4) % P) is not None for x in xs]
    if qr.tolist() != expect_qr:
        raise AssertionError("g1_decompress: the square test differs from the host's")

    # g1_scalar_mul: 2048 lanes with per-lane 255-bit scalars, 0 and r,
    # over lanes at infinity, Z != 1 and outside G1; then one broadcast
    # scalar (1/4096, the FFT's last step) on 4096 lanes
    jac, finite = monomial_lanes(setup, 2048, dev, seed=2)
    rng = random.Random(8)
    ks = [rng.randrange(1 << 255) for _ in range(2048)]
    ks[5], ks[6], ks[7] = 0, R, R - 1
    scalars16 = lb.as_limb_tensor(lb.ints_to_limbs(ks, 16), dev)
    got = kernels.scalar_mul(lb.to_u32_layout(jac), lb.to_u32_layout(scalars16), 256)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    plain = g1_ops.scalar_mul(jac, scalars16, 256)
    end.record()
    torch.cuda.synchronize()
    scalar_mul_plain_ms = start.elapsed_time(end)
    check(kernels.scalar_mul, "M=2048 (per-lane 255-bit scalars)", lb.to_u16_layout(got), plain)
    host_in, host_out = g1_ops.points_to_host(jac[:, :, :64]), g1_ops.points_to_host(
        lb.to_u16_layout(got)[:, :, :64])
    for pt, out, k in zip(host_in, host_out, ks):
        if not HC.points_eq(out, HC.point_scalar_mul_raw(pt, k) if pt[2] else HC.INFINITY):
            raise AssertionError("g1_scalar_mul differs from the host scalar multiplication")
    jac4k, _ = monomial_lanes(setup, 4096, dev, seed=3)
    n_inv = pow(4096, R - 2, R)
    got = g1_batch.scalar_mul_fixed(jac4k, n_inv)
    check(kernels.scalar_mul, "M=4096 (broadcast 1/4096)", got,
          g1_batch.scalar_mul_fixed(jac4k, n_inv, ops=g1_ops))

    # the split mode, as the conversion runs it: the inverse FFT's last
    # stage (2048 lanes of its twiddles) and [1/4096] on 4096 lanes; the
    # lanes outside G1 equal the plain version too, and a sample of those
    # in G1 the host [k]P
    stages, n_inv = g1_batch._twiddles(4096, True)
    split16 = lb.as_limb_tensor(g1_batch._split_limbs(stages[-1]), dev)
    got = kernels.scalar_mul(lb.to_u32_layout(jac), lb.to_u32_layout(split16), 128, split=True)
    start.record()
    plain = g1_ops.scalar_mul_endo(jac, split16)
    end.record()
    torch.cuda.synchronize()
    split_plain_ms = start.elapsed_time(end)
    check(kernels.scalar_mul, "M=2048 split mode (last-stage twiddles)", lb.to_u16_layout(got), plain)
    host_out = g1_ops.points_to_host(lb.to_u16_layout(got)[:, :, :64])
    for pt, out, k in zip(g1_ops.points_to_host(jac[:, :, :64]), host_out, stages[-1]):
        if pt[2] and HC.g1_in_subgroup(pt) and not HC.points_eq(out, HC.point_scalar_mul_raw(pt, k)):
            raise AssertionError("g1_scalar_mul's split mode differs from the host [k]P in G1")
    inv_split = g1_batch._split_limbs([n_inv])
    got = g1_batch.scalar_mul_in_g1(jac4k, inv_split)
    start.record()
    plain = g1_batch.scalar_mul_in_g1(jac4k, inv_split, ops=g1_ops)
    end.record()
    torch.cuda.synchronize()
    split_inv_plain_ms = start.elapsed_time(end)
    check(kernels.scalar_mul, "M=4096 split mode (broadcast 1/4096)", got, plain)

    # g1_fft_stage at the inverse FFT's first, a middle and its last stage
    # on 4096 lanes (at infinity, Z != 1, outside G1, t == even)
    split_stages, _ = g1_batch._split_twiddles(4096, True)
    fft_plain_ms = {}
    for length in FFT_STAGE_LENGTHS:
        split16 = lb.as_limb_tensor(split_stages[length.bit_length() - 2], dev)
        a = fft_stage_lanes(jac4k, length, split16, seed=length)
        got = kernels.fft_stage(lb.to_u32_layout(a), length, lb.to_u32_layout(split16))
        start.record()
        plain = g1_ops.fft_stage_endo(a, length, split16)
        end.record()
        torch.cuda.synchronize()
        fft_plain_ms[length] = start.elapsed_time(end)
        check(kernels.fft_stage, f"M=4096 l={length}", lb.to_u16_layout(got), plain)

    # the block and warp edges: the decompression, both modes and the
    # subgroup check
    for M in EDGE_LANES:
        y, qr = kernels.decompress(lb.to_u32_layout(x16[:, :M].contiguous()), want[:M].contiguous())
        y_plain, qr_plain = g1_ops.decompress_xy(x16[:, :M], want[:M])
        check(kernels.decompress, f"M={M} (y)", lb.to_u16_layout(y), y_plain)
        check(kernels.decompress, f"M={M} (square test)", qr.long(), qr_plain.long())
        lanes = jac4k[:, :, :M].contiguous()
        short = lb.as_limb_tensor(lb.ints_to_limbs([rng.randrange(1 << 16) for _ in range(M)], 16), dev)
        got = kernels.scalar_mul(lb.to_u32_layout(lanes), lb.to_u32_layout(short), 16)
        check(kernels.scalar_mul, f"M={M} (16-bit scalars)", lb.to_u16_layout(got),
              g1_ops.scalar_mul(lanes, short, 16))
        ks16 = lb.as_limb_tensor(g1_batch._split_limbs([rng.randrange(R) for _ in range(M)]), dev)
        got = kernels.scalar_mul(lb.to_u32_layout(lanes), lb.to_u32_layout(ks16), 128, split=True)
        check(kernels.scalar_mul, f"M={M} split mode", lb.to_u16_layout(got),
              g1_ops.scalar_mul_endo(lanes, ks16))
        got = kernels.subgroup_mask(lb.to_u32_layout(lanes))
        check(kernels.subgroup_mask, f"M={M}", got.long(), g1_ops.subgroup_mask(lanes).long())

    # g1_subgroup_mask: 4096 monomial lanes (some outside G1, some at
    # infinity) and 256 sums of neighbours; a sample against the host
    sums = g1_ops.add(jac4k[:, :, :256], jac4k[:, :, 1:257])
    lanes = torch.cat([jac4k, sums], dim=-1).contiguous()
    got = kernels.subgroup_mask(lb.to_u32_layout(lanes))
    plain = g1_ops.subgroup_mask(lanes)
    check(kernels.subgroup_mask, f"M={lanes.shape[-1]}", got.long(), plain.long())
    sample = list(range(0, lanes.shape[-1], 17))
    host = g1_ops.points_to_host(lanes[:, :, sample])
    if [bool(got[i]) for i in sample] != [HC.g1_in_subgroup(pt) for pt in host]:
        raise AssertionError("g1_subgroup_mask differs from the host g1_in_subgroup")
    log(f"  g1_subgroup_mask: {int((~got).sum())} of {lanes.shape[-1]} lanes outside G1, "
        f"{len(sample)} sampled lanes equal to the host g1_in_subgroup")
    return {"general": scalar_mul_plain_ms, "split": split_plain_ms, "split_inv": split_inv_plain_ms,
            "fft_stage": fft_plain_ms}


def ptxas_report(log_text: str, kernel: str, calls: bool = False) -> dict:
    """ptxas' registers, stack frame and spills of the entry function whose
    name holds `kernel`, from the build log, and with `calls` the mangled
    names of the functions it calls (ptxas lists their properties after
    the entry's)."""
    import re

    out, state = {}, None
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            state = "entry" if kernel in line else None
        elif state == "entry":
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                out.update(stack_bytes=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out["registers"] = int(m[1])
                state = "callees" if calls else None
                if calls:
                    out["calls"] = []
        elif state == "callees":
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                out["calls"].append(m[1])
    return out


def pairing_levels_report() -> dict:
    """Per kernel: the levels (product and inversion phases), linear
    waves, products and inversions of one run at B = 2, counted from the
    level programs the kernels run and the emulator's sequence of their
    subroutines (`pairing_levels.miller_calls`, `final_exp_calls`), which
    the kernels' loops in csrc/pairing.cu follow: printed in phase 2, not
    on the kernels line."""
    from lambdaworks_kzg_tpu_torch.ops import pairing_levels as PL

    miller, fe = PL.programs()
    return {"pairing_miller_loop": PL.count(miller, PL.miller_calls()),
            "pairing_final_exp": PL.count(fe, PL.final_exp_calls(2))}


def check_pairing_kernels(dev, max_err: dict) -> dict:
    """pairing_miller_loop and pairing_final_exp against their plain
    versions (pairing_ops.miller_loop_jac, final_exp_check) on the card,
    limb for limb, and FE^3 against the host pairing cubed: at B = 2, a
    true check (e(-[ab]G, G2) e([a]G, [b]G2)), and at B = 5, a false one
    with a member at infinity in two pairs. The plain versions run once
    per shape (seconds of small launches), timed with CUDA events (their
    ~0.7 M launches per check take minutes to profile: that is
    scripts/pairing_profile.py's) -> {"inputs": the B = 2 (G1, G2,
    Miller values) in the kernel layout, and the plain ms per shape}."""
    import torch

    from lambdaworks_kzg_tpu_torch.host import curve as HC, field as HF, pairing as HP
    from lambdaworks_kzg_tpu_torch.ops import kernels, limbs as lb, pairing_ops, tower_ops

    G, G2 = HC.G1_GENERATOR, HC.G2_GENERATOR
    pa, qb = HC.point_scalar_mul(G, 13), HC.g2_scalar_mul(G2, 29)
    neg_pab = HC.point_neg(HC.point_scalar_mul(G, 13 * 29))
    cases = (([(neg_pab, G2), (pa, qb)], True),
             ([(neg_pab, G2), (pa, HC.G2_INFINITY), (HC.point_scalar_mul(G, 5), qb),
               (HC.INFINITY, G2), (pa, qb)], False))
    out = {}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for pairs, verdict in cases:
        b = len(pairs)
        ps, qs = pairing_ops.jacobian_lanes(pairs, dev, seed=b)
        ps32, qs32 = lb.to_u32_layout(ps), lb.to_u32_layout(qs)
        f32 = kernels.miller_loop(ps32, qs32)
        fe32, ok = kernels.final_exp(f32)
        start.record()
        f_plain = pairing_ops.miller_loop_jac(ps, qs)
        end.record()
        torch.cuda.synchronize()
        miller_ms = start.elapsed_time(end)
        max_err["pairing_miller_loop"] = max(max_err["pairing_miller_loop"], same(
            f"pairing_miller_loop B={b}", lb.to_u16_layout(f32), f_plain))
        start.record()
        fe_plain, ok_plain = pairing_ops.final_exp_check(f_plain)
        end.record()
        torch.cuda.synchronize()
        final_ms = start.elapsed_time(end)
        max_err["pairing_final_exp"] = max(max_err["pairing_final_exp"], same(
            f"pairing_final_exp B={b}", lb.to_u16_layout(fe32), fe_plain))
        if ok.tolist() != ok_plain.tolist() or ok.tolist() != [verdict]:
            raise AssertionError(f"pairing B={b}: verdict {ok.tolist()} / plain "
                                 f"{ok_plain.tolist()}, not [{verdict}]")
        host = HP.pairing_batch(pairs)
        if tower_ops.fp12_to_host(tower_ops.unflatten12(lb.to_u16_layout(fe32))) != [
                HF.fp12_mul(HF.fp12_sqr(host), host)]:
            raise AssertionError(f"pairing_final_exp B={b}: FE^3 differs from the host's")
        log(f"  pairing_miller_loop and pairing_final_exp B={b}: equal to plain, limb for limb; "
            f"FE^3 equals the host pairing cubed; verdict {verdict}; plain {miller_ms:.0f} + "
            f"{final_ms:.0f} ms")
        out[f"b{b}"] = {"miller_plain_ms": miller_ms, "final_exp_plain_ms": final_ms}
        if b == 2:
            out["inputs"] = (ps32, qs32, f32)
    return out


def in_domain_quotient_host(evals, m: int, roots) -> list:
    """The quotient at z = w_m in Python ints, y = e_m: (e_i - y) /
    (w_i - z) for i != m, and q_m = sum_{i != m} (e_i - y) w_i /
    (z (z - w_i))."""
    from lambdaworks_kzg_tpu_torch.constants import R
    from lambdaworks_kzg_tpu_torch.host.field import batch_fr_inv

    z, y = roots[m], evals[m]
    inv = batch_fr_inv([(w - z) % R if i != m else 1 for i, w in enumerate(roots)])
    q = [(e - y) * d % R if i != m else 0 for i, (e, d) in enumerate(zip(evals, inv))]
    q[m] = -sum(qi * w for qi, w in zip(q, roots)) * pow(z, R - 2, R) % R
    return q


def check_fr_kernels(dev, max_err: dict) -> dict:
    """The Fr kernels against their plain versions on the card, limb for
    limb: fr_check against the plain FR on NTT_N elements (all pairs of 0,
    1, r - 1, r - 2, 2, R mod r, and seeded pairs); at the blob domain
    (n = NTT_N) for each of FR_BLOBS blobs of seeded elements below r,
    fr_to_mont against FR.to_mont, and fr_quotient_in_domain through
    FrDomain.quotient_in_domain on the plain limbs (m = 0, 1, n - 1 and a
    seeded m: each in a call of its own at B = 1, all four among the blobs
    at 6 and 64) against its plain version on their Montgomery form, blob
    0 also against the host's in-domain quotient; fr_evaluate (z outside
    the domain) and fr_quotient on
    the plain limbs and one z table, as FrDomain.open_mont runs them,
    against the plain versions of that route (FR.to_mont, then
    evaluate_mont_plain with y out of Montgomery form, and
    quotient_mont_plain), the table after them equal to the host's,
    open_mont against the two; blob 0's y and q against the host's;
    fr_evaluate at roots of unity equal to the stored elements, and
    evaluate_blobs_plain there. Each kernel timed on the
    main path's inputs (CUDA events behind a spin, 20 launches), its
    plain version once -> {kernel name: {"b<B>" or "m<M>": {"ms",
    "plain_ms", "bound_ms", "bound_by", ...}}}."""
    import numpy as np
    import torch

    from lambdaworks_kzg_tpu_torch.constants import R
    from lambdaworks_kzg_tpu_torch.host import fft
    from lambdaworks_kzg_tpu_torch.ops import fr_poly, kernels, limbs as lb
    from lambdaworks_kzg_tpu_torch.ops.field_ops import FR

    def check(name: str, what: str, got16, want16) -> None:
        max_err[name] = max(max_err[name], same(f"{name} {what}", got16, want16))

    n = NTT_N
    out = {name: {} for name in FR_KERNELS + ("fr_check",)}
    rng = random.Random(12)
    root_ms = (0, 1, n - 1, random.Random(FR_ROOT_SEED).randrange(2, n - 1))
    edge = [0, 1, R - 1, R - 2, 2, (1 << 256) % R]
    pairs = [(x, y) for x in edge for y in edge]
    pairs += [(rng.randrange(R), rng.randrange(R)) for _ in range(n - len(pairs))]
    a16, b16 = (lb.as_limb_tensor(lb.ints_to_limbs(v, 16), dev) for v in zip(*pairs))
    a32, b32 = lb.to_u32_layout(a16), lb.to_u32_layout(b16)
    got = lb.to_u16_layout(kernels.fr_check(a32, b32))
    want, plain_ms = events_ms(lambda: (FR.mul(a16, b16), FR.sqr(a16), FR.add(a16, b16), FR.sub(a16, b16),
                                        FR.neg(a16), FR.inv(a16), FR.to_mont(a16), FR.from_mont(a16)))
    for k, (op, w) in enumerate(zip(("mul", "sqr", "add", "sub", "neg", "inv", "to_mont", "from_mont"),
                                    want)):
        check("fr_check", f"M={n} {op}", got[k], w)
    out["fr_check"][f"m{n}"] = {"lanes": n, "ms": time_ms(lambda: kernels.fr_check(a32, b32), reps=20),
                                "plain_ms": plain_ms, **bound(*fr_kernel_work("fr_check", n, 1))}
    log(f"  fr_check M={n}: mul, sqr, add, sub, neg, inv, to_mont and from_mont equal the plain FR; "
        f"{out['fr_check'][f'm{n}']}")

    d = fr_poly.FrDomain(n, dev)
    nrng = np.random.default_rng(14)
    for blobs in FR_BLOBS:
        limbs = nrng.integers(0, 1 << 16, size=(blobs, 16, n), dtype=np.int64)
        limbs[:, 15] = nrng.integers(0, 0x73ED, size=(blobs, n))  # below r
        plain = torch.from_numpy(limbs).to(dev)
        zs = [rng.randrange(R) for _ in range(blobs)]
        z_m, zn1_m = d.z_consts(zs)
        evals_m = d.to_mont(plain)
        want, t_mont = events_ms(lambda: FR.to_mont(plain))
        check("fr_to_mont", f"B={blobs}", evals_m, want)
        evals0 = lb.limbs_to_ints(plain[0])
        for ms in ([[m] for m in root_ms] if blobs == 1 else [[root_ms[b % 4] for b in range(blobs)]]):
            onehot = torch.stack([torch.arange(n, device=dev) == m for m in ms])
            z_inv = torch.stack([d.mont([pow(d.roots_brp_ints[m], R - 2, R)]) for m in ms])
            q_in = d.quotient_in_domain(plain, ms)
            want, t_in = events_ms(lambda: d.quotient_in_domain_mont_plain(evals_m, onehot, z_inv))
            check("fr_quotient_in_domain", f"B={blobs} m={sorted(set(ms))}", q_in, want)
            if lb.limbs_to_ints(q_in[0]) != in_domain_quotient_host(evals0, ms[0], d.roots_brp_ints):
                raise AssertionError(f"B={blobs}: blob 0's quotient at w_{ms[0]} differs from the host's")
        root_table = d.root_table(ms)
        # the main path's inputs: the plain limbs and one table
        table = d.z_table(zs)
        y = kernels.fr_evaluate(plain, table, d.roots_k, d.n_inv_k)
        want_y, t_eval = events_ms(lambda: FR.from_mont(d.evaluate_mont_plain(FR.to_mont(plain), z_m, zn1_m)))
        check("fr_evaluate", f"B={blobs}", y, want_y)
        q = kernels.fr_quotient(plain, y, table, d.roots_k)
        want_q, t_quot = events_ms(lambda: d.quotient_mont_plain(FR.to_mont(plain), FR.to_mont(y), z_m))
        check("fr_quotient", f"B={blobs}", q, want_q)
        if not torch.equal(table.cpu(), torch.from_numpy(d.z_table_host(zs))):
            raise AssertionError(f"B={blobs}: the z table differs from the host's after the kernels")
        q_open, y_open = d.open_mont(plain, zs)
        if not (torch.equal(q_open, q) and torch.equal(y_open, y)):
            raise AssertionError(f"B={blobs}: open_mont differs from its kernels one by one")
        y0 = fft.barycentric_evaluate(evals0, zs[0], n)
        if lb.limbs_to_ints(y[0]) != [y0] or lb.limbs_to_ints(q[0]) != fft.quotient(evals0, zs[0], y0, n):
            raise AssertionError(f"B={blobs}: blob 0's y or quotient differs from the host's")
        stored = [int(lb.limbs_to_ints(plain[b, :, m : m + 1])[0]) for b, m in enumerate(ms)]
        at_roots = kernels.fr_evaluate(plain, d.z_table([d.roots_brp_ints[m] for m in ms]), d.roots_k,
                                       d.n_inv_k)
        if (lb.limbs_to_ints(at_roots[..., 0].T) != stored
                or d.evaluate_blobs_plain(plain, [d.roots_brp_ints[m] for m in ms]) != stored):
            raise AssertionError(f"B={blobs}: evaluations at roots differ from the stored elements")
        p32 = lb.to_u32_layout(plain)
        for name, fn, plain_ms in (
                ("fr_to_mont", lambda: kernels.fr_to_mont(p32), t_mont),
                ("fr_evaluate", lambda: kernels.fr_evaluate(plain, table, d.roots_k, d.n_inv_k), t_eval),
                ("fr_quotient", lambda: kernels.fr_quotient(plain, y, table, d.roots_k), t_quot),
                ("fr_quotient_in_domain",
                 lambda: kernels.fr_quotient_in_domain(plain, ms, root_table, d.roots_k), t_in)):
            shape = {"blobs": blobs, "n": n, "ms": time_ms(fn, reps=20), "plain_ms": plain_ms,
                     **bound(*fr_kernel_work(name, n, blobs))}
            if name == "fr_quotient_in_domain":
                shape["m"] = sorted(set(ms))
            out[name][f"b{blobs}"] = shape
            log(f"  {name} n={n} B={blobs}: equal to plain, limb for limb; kernel {shape['ms']:.4f} ms, "
                f"plain {plain_ms:.1f} ms, bound {shape['bound_ms']:.6f} ms ({shape['bound_by']})")
        log(f"  B={blobs}: blob 0's y and quotients (also at w_m) equal the host's; at the roots "
            f"m = {sorted(set(ms))} fr_evaluate gives the stored elements; the table equals the host's "
            "after the kernels")
    return out


def check_ntt(dev) -> tuple:
    """The NTT at the blob domain on the card: forward and inverse equal
    host/fft.fr_fft, the round trip, the coefficient bridge of a seeded
    blob (utils/blob.py) equal to the device inverse NTT; each direction's
    ms (CUDA events) and launches (profiler). -> (that record, (the input,
    [forward, inverse] on the card)) for phase 14."""
    import numpy as np

    from lambdaworks_kzg_tpu_torch.constants import R
    from lambdaworks_kzg_tpu_torch.host import fft
    from lambdaworks_kzg_tpu_torch.ops import limbs as lb, ntt
    from lambdaworks_kzg_tpu_torch.ops.field_ops import FR
    from lambdaworks_kzg_tpu_torch.utils import blob as blob_utils

    rng = random.Random(NTT_N)
    values = [rng.randrange(R) for _ in range(NTT_N)]
    out = {}
    for inverse in (False, True):
        t0 = time.perf_counter()
        got = ntt.ntt_ints(values, inverse, device=dev)
        host_s = time.perf_counter() - t0
        if got != fft.fr_fft(values, inverse):
            raise AssertionError(f"the NTT (inverse={inverse}) differs from fr_fft")
        x = lb.as_limb_tensor(FR.to_mont_host(values), dev)
        name = "inverse" if inverse else "forward"
        out[name] = {"ms": time_ms(lambda: ntt.ntt_device(x, inverse=inverse), reps=5),
                     "device": device_work(lambda: ntt.ntt_device(x, inverse=inverse)),
                     "ntt_ints_s": host_s}
        log(f"  NTT n={NTT_N} {name}: equal to fr_fft; {out[name]}")
    if ntt.ntt_ints(ntt.ntt_ints(values, device=dev), inverse=True, device=dev) != values:
        raise AssertionError("the NTT round trip differs")
    blob = random_blobs(np.random.default_rng(NTT_N), 1)[0]
    coeffs = blob_utils.blob_to_coefficients(blob, NTT_N)
    evals_nat = fft.bit_reversal_permutation(blob_utils.blob_to_evaluations(blob, NTT_N))
    if (ntt.ntt_ints(evals_nat, inverse=True, device=dev) != coeffs
            or blob_utils.coefficients_to_blob(coeffs, NTT_N) != blob):
        raise AssertionError("the coefficient bridge differs from the NTT on the card")
    log("  round trip exact; a seeded blob's coefficients equal the inverse NTT on the card, "
        "and coefficients_to_blob gives the blob back")
    return out, (values, [ntt.ntt_ints(values, inverse, device=dev) for inverse in (False, True)])


def convert_stages(path: str, dev) -> dict:
    """One conversion of a setup file, its stages timed apart: the host
    parse, the G2 decompressions (host), the device part
    (srs.convert_g1_device, the decompression, subgroup check and inverse
    FFT that load_trusted_setup_file runs, to a synchronize) and the
    affine step with the bit reversal (host)."""
    import torch

    from lambdaworks_kzg_tpu_torch.host import fft
    from lambdaworks_kzg_tpu_torch.models import srs
    from lambdaworks_kzg_tpu_torch.ops import g1_batch

    t = [time.perf_counter()]
    with open(path, "r", encoding="utf-8") as f:
        g1_bytes, g2_bytes = srs._parse_setup_text(f.read())
    t.append(time.perf_counter())
    srs._decompress_g2_list(g2_bytes)
    t.append(time.perf_counter())
    jac, lagrange = srs.convert_g1_device(g1_bytes, dev)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    brp = torch.tensor(fft.bit_reversal_permutation(list(range(len(g1_bytes)))), device=dev)
    g1_batch.jacobians_to_host_affine(lagrange.index_select(-1, brp))
    g1_batch.jacobians_to_host_affine(jac)
    t.append(time.perf_counter())
    names = ("parse_s", "g2_host_s", "device_s", "affine_host_s")
    return {name: t[i + 1] - t[i] for i, name in enumerate(names)}


def verify_split(ctx, blobs, commitments, proofs) -> dict:
    """The stages of one verify_blob_kzg_proof_batch timed apart on the host
    clock, each ending in a transfer to the host: the batched
    decompression and subgroup check, the challenges (host hashing), the
    blob evaluations on the card, the batch of three generic MSMs alone
    (one msm_batch call), and KZG.verify_batch (the same MSMs and the
    context's pairing check)."""
    from lambdaworks_kzg_tpu_torch.host import curve as HC
    from lambdaworks_kzg_tpu_torch.utils import hashing as H

    backend, n = ctx.backend, len(blobs)
    t = [time.perf_counter()]
    points = backend.decompress_g1_batch(commitments + proofs)
    t.append(time.perf_counter())
    zs = [H.compute_challenge(b, c, ctx.n) for b, c in zip(blobs, commitments)]
    t.append(time.perf_counter())
    ys = backend.evaluate_scalars(backend.blob_scalars(blobs), zs)
    t.append(time.perf_counter())
    rs = H.compute_r_powers(commitments, zs, ys, proofs, ctx.n)
    backend.msm_batch(*verify_rows(rs, zs, ys, [HC.to_affine(p) for p in points[n:]],
                                   [HC.to_affine(p) for p in points[:n]]))
    t.append(time.perf_counter())
    if not ctx.kzg.verify_batch(points[:n], zs, ys, points[n:], rs):
        raise AssertionError("the split batch verification rejected a true batch")
    t.append(time.perf_counter())
    names = ("decompress_ms", "challenges_ms", "evaluate_ms", "msm_batch_ms", "msm_and_pairing_ms")
    return {name: (t[i + 1] - t[i]) * 1e3 for i, name in enumerate(names)}


def verify_rows(rs, zs, ys, proof_aff, commit_aff):
    """KZG.verify_batch's one batch of MSMs: (rows, points) over [proofs,
    commitments, G1], rows r^i and r^i z_i on the proofs, r^i on the
    commitments with -sum r^i y_i on G1."""
    from lambdaworks_kzg_tpu_torch.constants import R
    from lambdaworks_kzg_tpu_torch.host import curve as HC

    zero = [0] * len(rs)
    rows = [rs + zero + [0], [r * z % R for r, z in zip(rs, zs)] + zero + [0],
            zero + rs + [(-sum(r * y for r, y in zip(rs, ys))) % R]]
    return rows, proof_aff + commit_aff + [HC.to_affine(HC.G1_GENERATOR)]


def batch_msm_inputs(ctx, blobs, commitments, proofs):
    """The batch of generic MSMs of verify_blob_kzg_proof_batch on these
    blobs, as KZG.verify_batch forms it -> (rows, points): three rows over
    2 n + 1 points (n, n and n + 1 of them weighted)."""
    from lambdaworks_kzg_tpu_torch.host import curve as HC
    from lambdaworks_kzg_tpu_torch.utils import hashing as H

    n = len(blobs)
    points = ctx.backend.decompress_g1_batch(list(commitments) + list(proofs))
    zs = [H.compute_challenge(b, c, ctx.n) for b, c in zip(blobs, commitments)]
    ys = ctx.backend.evaluate_blobs(blobs, zs)
    r = H.compute_r_powers(list(commitments), zs, ys, list(proofs), ctx.n)
    return verify_rows(r, zs, ys, [HC.to_affine(pt) for pt in points[n:]],
                       [HC.to_affine(pt) for pt in points[:n]])


def verify_msm_stages(ctx, blobs, commitments, proofs, card: str) -> dict:
    """A batch verification's batch of generic MSMs on the card,
    `msm.msm_batch_device` at the window backend.msm_batch picks (that of
    the widest row, n + 1 points), equal to backend.msm_batch's points and
    split by `msm_stages` (device time under the profiler) -> {"points",
    "msms", "c", stage ms}."""
    import torch

    from lambdaworks_kzg_tpu_torch.host import curve as HC
    from lambdaworks_kzg_tpu_torch.ops import dispatch, g1_ops, limbs as lb, msm
    from lambdaworks_kzg_tpu_torch.ops.backend import auto_window

    dev = ctx.backend.device
    rows, affine = batch_msm_inputs(ctx, blobs, commitments, proofs)
    c = auto_window(len(blobs) + 1)
    pts, valid = g1_ops.make_points_host(affine)
    pts, valid = lb.as_limb_tensor(pts, dev), torch.from_numpy(valid).to(dev)
    k = torch.stack([msm.scalars_to_tensor(row, dev) for row in rows])
    got = g1_ops.points_to_host(dispatch.from_op_layout(msm.msm_batch_device(pts, valid, k, c)))
    want = ctx.backend.msm_batch(rows, affine)
    if [HC.to_affine(p) for p in got] != [HC.to_affine(p) for p in want]:
        raise AssertionError("msm_batch_device differs from backend.msm_batch on a batch verification")
    stages = msm_stages(lambda: msm.msm_batch_device(pts, valid, k, c))
    log(f"  the batch of {len(rows)} generic MSMs over {len(affine)} points, c={c}: device ms by "
        f"stage {stages} ({card})")
    return {"points": len(affine), "msms": len(rows), "c": c, **stages}


def host_conversion(path: str) -> dict:
    """A setup file converted by the port's host oracles, as a cache's
    arrays: each G1 point decompressed and subgroup-checked in Python
    ints, the host inverse G1 FFT, the bit reversal."""
    from lambdaworks_kzg_tpu_torch.host import curve as HC, fft
    from lambdaworks_kzg_tpu_torch.models import srs

    with open(path, "r", encoding="utf-8") as f:
        g1_bytes, g2_bytes = srs._parse_setup_text(f.read())
    monomial = [HC.decompress_g1(b, subgroup_check=True) for b in g1_bytes]
    lagrange = fft.bit_reversal_permutation(fft.g1_fft(monomial, inverse=True))
    return {"lagrange": srs._affine_g1_to_u8([HC.to_affine(p) for p in lagrange]),
            "monomial": srs._affine_g1_to_u8([HC.to_affine(p) for p in monomial]),
            "g2": srs._affine_g2_to_u8(srs._decompress_g2_list(g2_bytes))}


def same_npz(got_path: str, want) -> None:
    """The cache file at got_path holds `want`'s lagrange, monomial and g2
    arrays (another cache file's path, or a dict of arrays)."""
    import numpy as np

    with np.load(got_path) as got:
        want = dict(np.load(want)) if isinstance(want, str) else want
        for key in ("lagrange", "monomial", "g2"):
            if got[key].dtype != want[key].dtype or not np.array_equal(got[key], want[key]):
                raise AssertionError(f"{got_path}: {key} differs")


def expect_launches(what: str, before: dict, want: dict) -> None:
    """The launches since `before` are `want` by kernel name, none other."""
    delta = {name: n - before[name] for name, n in launch_counts().items()}
    full = {name: want.get(name, 0) for name in delta}
    if delta != full:
        raise AssertionError(f"{what}: launches {delta}, not {full}")


def mesh_batch_launches(mesh) -> dict:
    """One commitment or proof batch on a mesh (ops/backend.py, the batch
    step of parallel/msm.py): an accumulation and a reduce per shard on
    every row, and on each row one g1_fold launch of its fold where it has
    more than one shard."""
    d, p = mesh.shape["data"], mesh.shape["points"]
    return {"g1_bucket_accumulate": d * p, "g1_bucket_reduce": d * p, "g1_fold": d * (p > 1)}


def mesh_generic_launches(mesh, sharded: bool, shard: str = "points", windows: int = 0) -> dict:
    """One generic MSM on a mesh (parallel/msm.py), no table: unsharded
    on the lead device (an accumulation, a reduce, a combine), or over
    row 0 by points (an accumulation and a reduce a shard, the row's fold
    where P > 1, the combine) or by windows (an accumulation and a reduce
    for each shard that holds some of the `windows`, the combine)."""
    if not sharded:
        return dict(GENERIC_LAUNCHES)
    p = mesh.shape["points"]
    if shard == "windows":
        shards = -(-windows // -(-windows // p))
        return {"g1_bucket_accumulate": shards, "g1_bucket_reduce": shards, "g1_window_combine": 1}
    return {"g1_bucket_accumulate": p, "g1_bucket_reduce": p, "g1_fold": int(p > 1),
            "g1_window_combine": 1}


def mesh_verify_launches(mesh, n_blobs: int) -> dict:
    """One verify_blob_kzg_proof_batch of n >= 2 blobs that pass their
    checks, on a mesh: its decompression, subgroup check and pairing check
    on the lead device, and one batch of three generic MSMs (the widest
    row n + 1 points), over the mesh's rows by points above max(16, 2 P)
    such points (TorchBackend.msm_batch: an accumulation and a reduce a
    shard, a fold a row where P > 1, one combine), else on the lead
    device."""
    want = {"g1_decompress": 1, "g1_subgroup_mask": 1, **FR_EVAL_LAUNCHES, **PAIRING_LAUNCHES}
    d, p = mesh.shape["data"], mesh.shape["points"]
    if n_blobs + 1 > max(16, 2 * p):
        batch = {"g1_bucket_accumulate": d * p, "g1_bucket_reduce": d * p, "g1_fold": d * (p > 1),
                 "g1_window_combine": 1}
    else:
        batch = dict(GENERIC_LAUNCHES)
    for name, n in batch.items():
        want[name] = want.get(name, 0) + n
    return want


def check_mesh(setup, dev, commit_set, prove_set, verify_batches) -> dict:
    """Phase 11: the port's multi-device tier (parallel/) on logical meshes
    over `dev` four times, (1, 1), (2, 2) and (1, 4), and on a mesh of every
    card when there are more than one. On each: the backend's init builds
    one table per device; each shard's table equals its rows of the
    committed table; the 10 commitment vectors; batches of 6 and of 5
    blobs (5 does not divide over 2 rows) equal phase 6's commitments and
    a batch of 6 proofs phase 9's, each call in exactly
    `mesh_batch_launches` (a proof batch also FR_PROOF_LAUNCHES on the
    lead device); a generic sharded MSM of a blob over the 4096
    Lagrange points equals its commitment by points, windows and auto;
    the 23 verify_blob_kzg_proof_batch vectors; seeded batches of 6 and 64
    verified true and false, each in `mesh_verify_launches`. Then the
    sharded NTT and inverse at n = 4096 on 2 and 4 devices equal
    host/fft.fr_fft. Batches of 6 are timed with CUDA events: on a logical
    mesh that is one card doing every shard's work, no multi-card time."""
    import numpy as np
    import torch

    from lambdaworks_kzg_tpu_torch import EIP4844Context, KZGError
    from lambdaworks_kzg_tpu_torch.constants import R, num_windows
    from lambdaworks_kzg_tpu_torch.host import curve as HC, fft
    from lambdaworks_kzg_tpu_torch.ops import codec, limbs as lb
    from lambdaworks_kzg_tpu_torch.ops.backend import TorchBackend
    from lambdaworks_kzg_tpu_torch.parallel import make_mesh, sharded_msm
    from lambdaworks_kzg_tpu_torch.parallel.msm import resolve_shard
    from lambdaworks_kzg_tpu_torch.parallel.ntt import sharded_ntt_ints
    from lambdaworks_kzg_tpu_torch.utils.yaml_vectors import load_commitment_vector

    count = torch.cuda.device_count()
    log(f"  {count} CUDA device(s): {[torch.cuda.get_device_name(i) for i in range(count)]}")
    meshes = [(f"logical {d}x{p} over {dev}", make_mesh([dev] * 4, data=d, points=p))
              for d, p in MESH_SHAPES]
    if count > 1:
        real = make_mesh()
        meshes.append((f"{real.shape['data']}x{real.shape['points']} over {count} cards", real))
    commit_blobs, commit_batch = commit_set
    prove_blobs, prove_cs, prove_want = prove_set
    n, w = setup.n, num_windows(C_MAIN)
    with np.load(FIXEDBASE) as ref:
        ref_table = ref["table"].reshape(2, 24, w, n)
        ref_valid = ref["valid"].reshape(w, n)
    points = lb.as_limb_tensor(setup.lagrange_points)
    valid = torch.from_numpy(setup.lagrange_valid.copy())
    scalars = lb.as_limb_tensor(codec.blob_to_limbs(commit_blobs[0], n), dev)
    names = sorted(os.listdir(VECTORS))
    if len(names) != 10:
        raise AssertionError(f"{len(names)} commitment vectors, not 10")
    out = {}
    for label, mesh in meshes:
        res = {"shape": mesh.shape}
        before = launch_counts()
        backend = TorchBackend(setup, mesh=mesh)
        torch.cuda.synchronize()
        devices = {d for row in mesh.devices for d in row}
        expect_launches(f"{label}: init", before, {"g1_fixedbase_table": len(devices)})
        width = n // mesh.shape["points"]
        for (d, p) in backend.shards.tables:
            table16, table_valid = backend.shards.public(d, p)
            cols = slice(p * width, (p + 1) * width)
            if not (np.array_equal(table16.cpu().numpy().astype(np.uint32),
                                   ref_table[..., cols].reshape(2, 24, -1))
                    and np.array_equal(table_valid.cpu().numpy(), ref_valid[:, cols].reshape(-1))):
                raise AssertionError(f"{label}: shard {p}'s table on {d} differs from its rows of "
                                     f"{os.path.relpath(FIXEDBASE, HERE)}")
        ctx = EIP4844Context(setup, backend=backend)
        for name in names:
            blob, want = load_commitment_vector(os.path.join(VECTORS, name, "data.yaml"))
            try:
                got = ctx.blob_to_kzg_commitment(blob)
            except KZGError:
                got = None
            if got != want:
                raise AssertionError(f"{label}: commitment vector {name} wrong")
        per_batch = mesh_batch_launches(mesh)
        for k in (6, 5):
            before = launch_counts()
            got = ctx.blob_to_kzg_commitment_batch(commit_blobs[:k])
            expect_launches(f"{label}: a batch of {k} commitments", before, per_batch)
            if got != commit_batch[:k]:
                raise AssertionError(f"{label}: a batch of {k} commits unlike phase 6")
        res["commit_batch6_ms"] = [events_ms(lambda: ctx.blob_to_kzg_commitment_batch(commit_blobs))[1]
                                   for _ in range(2)]
        for shard in ("points", "windows", "auto"):
            before = launch_counts()
            pt = sharded_msm(mesh, points, valid, scalars, C_MAIN, shard)
            expect_launches(f"{label}: sharded_msm by {shard}", before,
                            mesh_generic_launches(mesh, True, resolve_shard(mesh, n, shard),
                                                  num_windows(C_MAIN, 255)))
            if HC.compress_g1(pt) != commit_batch[0]:
                raise AssertionError(f"{label}: sharded_msm by {shard} differs from the commitment")
        before = launch_counts()
        proofs, ms = events_ms(lambda: ctx.compute_blob_kzg_proof_batch(prove_blobs, prove_cs))
        expect_launches(f"{label}: a batch of 6 proofs", before, {**per_batch, **FR_PROOF_LAUNCHES})
        if proofs != prove_want:
            raise AssertionError(f"{label}: a batch of 6 proofs unlike phase 9")
        res["prove_batch6_ms"] = ms
        run_vectors(ctx, "verify_blob_kzg_proof_batch")
        res["verify_batch_ms"] = {}
        for k, (blobs, cs, ps) in verify_batches.items():
            swapped = [ps[1], ps[0]] + ps[2:]
            for verdict, proofs in ((True, ps), (False, swapped)):
                before = launch_counts()
                got, ms = events_ms(lambda: ctx.verify_blob_kzg_proof_batch(blobs, cs, proofs))
                expect_launches(f"{label}: a batch verify of {k}", before, mesh_verify_launches(mesh, k))
                if got is not verdict:
                    raise AssertionError(f"{label}: {k} seeded blobs verified {got}, not {verdict}")
                res["verify_batch_ms"][f"{k} {verdict}".lower()] = ms
        log(f"  {label}: init one table per device; shard tables equal the committed rows; 10/10 "
            f"commitment vectors; batches of 6 and 5 equal phase 6, 6 proofs phase 9, each in "
            f"{per_batch}; sharded_msm by points, windows and auto equals the commitment; 23/23 "
            f"batch vectors; seeded batches verified as they should; ms {res}")
        out[label] = res
    rng = random.Random(NTT_N + 1)
    values = [rng.randrange(R) for _ in range(NTT_N)]
    want = {inverse: fft.fr_fft(values, inverse) for inverse in (False, True)}
    for d, p, axis in ((1, 2, "points"), (2, 2, "data"), (1, 4, "points")):
        mesh = make_mesh([dev] * 4, data=d, points=p)
        for inverse in (False, True):
            if sharded_ntt_ints(mesh, axis, values, inverse) != want[inverse]:
                raise AssertionError(f"the sharded NTT on {d}x{p} ({axis}, inverse={inverse}) "
                                     "differs from fr_fft")
    log(f"  sharded NTT and inverse, n={NTT_N}, on 2 and 4 devices of a logical mesh: equal to "
        "fr_fft")
    return out


# -- phase 12: the C ABI (lambdaworks_kzg_tpu_torch/capi) ---------------------


class KZGSettings(ctypes.Structure):
    """c_kzg_4844.h's KZGSettings."""
    _fields_ = [("fs", ctypes.c_void_p), ("g1_values", ctypes.c_void_p),
                ("g2_values", ctypes.c_void_p)]


def capi_library():
    """(the port's C library, built if stale and loaded, build info)."""
    from lambdaworks_kzg_tpu_torch import capi

    info = capi.build()
    lib = ctypes.CDLL(info["library"])
    for fn in ("load_trusted_setup", "load_trusted_setup_file") + CAPI_FNS:
        getattr(lib, fn).restype = ctypes.c_int
    lib.free_trusted_setup.restype = None
    return lib, info


def capi_load_file(lib, path: str):
    """load_trusted_setup_file on a FILE * of `path` -> (code, settings)."""
    libc = ctypes.CDLL(None)
    libc.fopen.restype = ctypes.c_void_p
    fp = libc.fopen(path.encode(), b"r")
    if not fp:
        raise AssertionError(f"cannot open {path}")
    settings = KZGSettings()
    try:
        ret = lib.load_trusted_setup_file(ctypes.byref(settings), ctypes.c_void_p(fp))
    finally:
        libc.fclose(ctypes.c_void_p(fp))
    return ret, settings


def capi_call(lib, settings, fn: str, args):
    """One C call -> (code, output shaped as the vector's, None unless OK).
    A batch's args are the three lists."""
    s = ctypes.byref(settings)
    if fn == "verify_blob_kzg_proof_batch":
        blobs, cs, ps = args
        args = (b"".join(blobs), b"".join(cs), b"".join(ps), ctypes.c_size_t(len(blobs)))
    if fn.startswith("verify"):
        ok = ctypes.c_bool(False)
        ret = getattr(lib, fn)(ctypes.byref(ok), *args, s)
        return ret, (ok.value if ret == C_KZG_OK else None)
    if fn == "compute_kzg_proof":
        proof, y = ctypes.create_string_buffer(48), ctypes.create_string_buffer(32)
        ret = lib.compute_kzg_proof(proof, y, *args, s)
        return ret, ([proof.raw, y.raw] if ret == C_KZG_OK else None)
    out = ctypes.create_string_buffer(48)
    ret = getattr(lib, fn)(out, *args, s)
    return ret, (out.raw if ret == C_KZG_OK else None)


def capi_args(fn: str, inp: dict):
    """A vector's inputs as the C call's, or None where the fixed-size ABI
    cannot express them (a wrong length, or batch lists of unequal
    lengths)."""
    names = VECTOR_ARGS[fn]
    if fn == "verify_blob_kzg_proof_batch":
        lists = [inp[a] for a in names]
        if len({len(x) for x in lists}) != 1 or any(len(v) != CAPI_SIZES[a]
                                                    for a, x in zip(names, lists) for v in x):
            return None
        return tuple(lists)
    if any(len(inp[a]) != CAPI_SIZES[a] for a in names):
        return None
    return tuple(inp[a] for a in names)


def capi_launches(fn: str, ret: int, n_blobs: int, z_in_domain: bool = False):
    """The launches one C call must make: the MSM kernels once for a
    commitment, and for a proof beside them FR_PROOF_LAUNCHES
    (FR_ROOT_LAUNCHES where z is a root of unity), the pairing kernels once
    for a verdict, a batch of n >= 2 VERIFY_BATCH_LAUNCHES, nothing for a
    call that fails its input checks; None for a failed batch (at most one
    g1_decompress and one g1_subgroup_mask, which run before its blob
    checks)."""
    if ret != C_KZG_OK:
        return None if fn == "verify_blob_kzg_proof_batch" else {}
    if fn == "blob_to_kzg_commitment":
        return MSM_LAUNCHES
    if not fn.startswith("verify"):
        return {**MSM_LAUNCHES, **(FR_ROOT_LAUNCHES if z_in_domain else FR_PROOF_LAUNCHES)}
    if fn == "verify_blob_kzg_proof_batch" and n_blobs != 1:
        return VERIFY_BATCH_LAUNCHES if n_blobs else {}
    return PAIRING_LAUNCHES


def run_capi_vectors(lib, settings) -> dict:
    """All 208 consensus vectors through the seven C functions: each
    output byte-equal to the vector's and C_KZG_BADARGS for a null one,
    each call in its `capi_launches`; a vector the fixed-size ABI cannot
    express must expect null. -> {fn: {vectors, inexpressible, s}}."""
    from lambdaworks_kzg_tpu_torch.host import fft
    from lambdaworks_kzg_tpu_torch.utils.yaml_vectors import load_case

    roots = set(fft.fr_roots_of_unity(NTT_N))
    out, total = {}, 0
    for fn in CAPI_FNS:
        names = sorted(os.listdir(os.path.join(CONSENSUS, fn, "small")))
        t0, wrong, skipped = time.perf_counter(), [], 0
        for name in names:
            case = load_case(os.path.join(CONSENSUS, fn, "small", name, "data.yaml"))
            args = capi_args(fn, case["input"])
            if args is None:
                skipped += 1
                if case["output"] is not None:
                    wrong.append(name)
                continue
            before = launch_counts()
            ret, got = capi_call(lib, settings, fn, args)
            n_blobs = len(args[0]) if fn == "verify_blob_kzg_proof_batch" else 1
            in_domain = fn == "compute_kzg_proof" and int.from_bytes(args[1], "little") in roots
            want = capi_launches(fn, ret, n_blobs, in_domain)
            if want is None:
                delta = {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
                if any(n > 1 or k not in ("g1_decompress", "g1_subgroup_mask") for k, n in delta.items()):
                    raise AssertionError(f"{name}: a failed batch launched {delta}")
            else:
                expect_launches(name, before, want)
            if case["output"] is None:
                ok = ret == C_KZG_BADARGS
            else:
                ok = ret == C_KZG_OK and got == case["output"] and type(got) is type(case["output"])
            if not ok:
                wrong.append(name)
        dt = time.perf_counter() - t0
        total += len(names)
        log(f"  {fn}: {len(names) - len(wrong)}/{len(names)} as the vectors have them through the "
            f"C ABI in {dt:.2f} s ({skipped} not expressible at the ABI's fixed sizes, all expecting "
            f"null)")
        if wrong or len(names) != VECTOR_COUNTS[fn]:
            raise AssertionError(f"C ABI {fn}: wrong on {wrong} ({len(names)} vectors)")
        out[fn] = {"vectors": len(names), "inexpressible": skipped, "s": dt}
    if total != CAPI_VECTOR_COUNT:
        raise AssertionError(f"{total} vectors, not {CAPI_VECTOR_COUNT}")
    return out


def fp_from_blst(mem: bytes) -> int:
    """blst_fp {u64 l[6]} memory, l[0] the most significant word -> int."""
    return sum(w << (64 * (5 - i)) for i, w in enumerate(struct.unpack("<6Q", mem)))


def check_blst_tables(settings, g1_bytes, g2_bytes) -> None:
    """KZGSettings' first and last blst_p1 and blst_p2 entries hold the
    setup file's points: canonical coordinates, z = 1."""
    from lambdaworks_kzg_tpu_torch.host import curve as HC

    n1, n2 = len(g1_bytes), len(g2_bytes)
    g1_mem = ctypes.string_at(settings.g1_values, 144 * n1)
    g2_mem = ctypes.string_at(settings.g2_values, 288 * n2)
    for i in (0, n1 - 1):
        x, y, z = (fp_from_blst(g1_mem[144 * i + 48 * k : 144 * i + 48 * k + 48]) for k in range(3))
        if ((x, y), z) != (HC.to_affine(HC.decompress_g1(g1_bytes[i])), 1):
            raise AssertionError(f"blst G1 table entry {i} is not the setup's point")
    for i in (0, n2 - 1):
        v = [fp_from_blst(g2_mem[288 * i + 48 * k : 288 * i + 48 * k + 48]) for k in range(6)]
        if (((v[0], v[1]), (v[2], v[3])), v[4], v[5]) != (
                HC.g2_to_affine(HC.decompress_g2(g2_bytes[i])), 1, 0):
            raise AssertionError(f"blst G2 table entry {i} is not the setup's point")


def check_capi(lib, settings, ctx, card: str) -> tuple:
    """Phase 12 after its vectors: the tables; load_trusted_setup on the
    file's points (one more table launch, the same tables) and on a wrong
    count (BADARGS, no launch); blob_to_kzg_commitment,
    compute_blob_kzg_proof and verify_blob_kzg_proof timed through the ABI
    and on the Python context `ctx`, in turns, equal results; kzg_client's
    blob committed, proved and verified in process. -> (results, launches
    of the Python calls, to leave out of the path's)."""
    import numpy as np

    from lambdaworks_kzg_tpu_torch import capi
    from lambdaworks_kzg_tpu_torch.models import srs

    with open(srs.MAINNET_SETUP_PATH) as f:
        g1_bytes, g2_bytes = srs._parse_setup_text(f.read())
    check_blst_tables(settings, g1_bytes, g2_bytes)
    n1, n2 = len(g1_bytes), len(g2_bytes)
    g1, g2 = b"".join(g1_bytes), b"".join(g2_bytes)
    parts = KZGSettings()
    before = launch_counts()
    if lib.load_trusted_setup(ctypes.byref(parts), g1, ctypes.c_size_t(n1), g2, ctypes.c_size_t(n2)):
        raise AssertionError("load_trusted_setup on the mainnet points failed")
    expect_launches("load_trusted_setup", before, {"g1_fixedbase_table": 1})
    same = (ctypes.string_at(parts.g1_values, 144 * n1) == ctypes.string_at(settings.g1_values, 144 * n1)
            and ctypes.string_at(parts.g2_values, 288 * n2) == ctypes.string_at(settings.g2_values, 288 * n2))
    lib.free_trusted_setup(ctypes.byref(parts))
    if not same or parts.fs or parts.g1_values or parts.g2_values:
        raise AssertionError("load_trusted_setup's tables differ, or free_trusted_setup left them")
    before = launch_counts()
    if lib.load_trusted_setup(ctypes.byref(parts), g1, ctypes.c_size_t(n1 - 1), g2,
                              ctypes.c_size_t(n2)) != C_KZG_BADARGS:
        raise AssertionError("load_trusted_setup on 4095 G1 points is not BADARGS")
    expect_launches("load_trusted_setup, wrong count", before, {})
    log(f"  blst tables: first and last G1 and G2 entries are the setup file's points; "
        f"load_trusted_setup on its {n1} + {n2} points: the same tables, one table launch; on "
        f"{n1 - 1}: BADARGS")

    blob = random_blobs(np.random.default_rng(4850), 1)[0]
    _, c = capi_call(lib, settings, "blob_to_kzg_commitment", (blob,))
    _, p = capi_call(lib, settings, "compute_blob_kzg_proof", (blob, c))
    calls = {
        "blob_to_kzg_commitment": ((blob,), lambda: ctx.blob_to_kzg_commitment(blob)),
        "compute_blob_kzg_proof": ((blob, c), lambda: ctx.compute_blob_kzg_proof(blob, c)),
        "verify_blob_kzg_proof": ((blob, c, p), lambda: ctx.verify_blob_kzg_proof(blob, c, p)),
    }
    excluded = dict.fromkeys(launch_counts(), 0)
    timing = {}
    for fn, (args, py) in calls.items():
        abi_ms, py_ms = [], []
        for _ in range(CAPI_REPS):
            t0 = time.perf_counter()
            ret, got = capi_call(lib, settings, fn, args)
            abi_ms.append((time.perf_counter() - t0) * 1e3)
            before = launch_counts()
            t0 = time.perf_counter()
            want = py()
            py_ms.append((time.perf_counter() - t0) * 1e3)
            for k, n in launch_counts().items():
                excluded[k] += n - before[k]
            if ret != C_KZG_OK or got != want:
                raise AssertionError(f"{fn}: the ABI gave ({ret}, {got!r}), the context {want!r}")
        timing[fn] = {"abi_ms": abi_ms, "python_ms": py_ms, "abi_median_ms": statistics.median(abi_ms),
                      "python_median_ms": statistics.median(py_ms)}
        log(f"  {fn}: median of {CAPI_REPS} through the ABI {timing[fn]['abi_median_ms']:.3f} ms, on "
            f"the Python context {timing[fn]['python_median_ms']:.3f} ms ({card}; host clock)")

    client_blob = capi.client_blob(CLIENT_SEED)
    _, cc = capi_call(lib, settings, "blob_to_kzg_commitment", (client_blob,))
    _, cp = capi_call(lib, settings, "compute_blob_kzg_proof", (client_blob, cc))
    ret, ok = capi_call(lib, settings, "verify_blob_kzg_proof", (client_blob, cc, cp))
    if ret != C_KZG_OK or ok is not True:
        raise AssertionError("the client's blob did not verify in process")
    client_want = f"commitment {cc.hex()}\nproof {cp.hex()}\nverified 1\n"
    return {"timing": timing, "client_expected": client_want}, excluded


def run_capi_client(expected: str) -> dict:
    """kzg_client.c built against the port's header and library, run as a
    C program on the mainnet setup (its embedded interpreter on PYTHONPATH
    = the repository root and this interpreter's site directories, the
    card by default); its output must equal the in-process result."""
    from lambdaworks_kzg_tpu_torch import capi
    from lambdaworks_kzg_tpu_torch.models import srs

    built = capi.build_client(4096)
    env = capi.client_env()
    env.pop("LWKZG_BACKEND", None)
    t0 = time.perf_counter()
    proc = subprocess.run([built["path"], srs.MAINNET_SETUP_PATH, str(CLIENT_SEED)], env=env,
                          capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0 or proc.stdout != expected:
        raise AssertionError(f"kzg_client exited {proc.returncode}: {proc.stdout!r} (expected "
                             f"{expected!r}); stderr {proc.stderr[-2000:]}")
    log(f"  kzg_client (cc {built['seconds']:.2f} s): exit 0 in {seconds:.2f} s, its commitment, "
        f"proof and verdict equal to the in-process calls'")
    return {"cc_s": built["seconds"], "run_s": seconds}


def capi_phase(ctx, card: str):
    """Phase 12: the port's C library built by cc; the mainnet setup loaded
    through load_trusted_setup_file on the card (one table launch); the 208
    vectors (`run_capi_vectors`); `check_capi`; the path's launches (the C
    calls', less the Python context's), every one of CAPI_KERNELS
    launched; then `run_capi_client`. -> (results, launches)."""
    from lambdaworks_kzg_tpu_torch.models import srs
    from lambdaworks_kzg_tpu_torch.ops import kernels

    lib, info = capi_library()
    results = {"build_s": info["seconds"]}
    log(f"  cc built {os.path.relpath(info['library'], HERE)} in {info['seconds']:.2f} s")
    kernels.reset_counts()  # the C ABI's path starts here
    t0 = time.perf_counter()
    ret, settings = capi_load_file(lib, srs.MAINNET_SETUP_PATH)
    results["load_s"] = time.perf_counter() - t0
    if ret != C_KZG_OK:
        raise AssertionError(f"load_trusted_setup_file -> {ret}")
    expect_launches("load_trusted_setup_file", dict.fromkeys(launch_counts(), 0),
                    {"g1_fixedbase_table": 1})  # the context is on the card
    log(f"  load_trusted_setup_file({os.path.relpath(srs.MAINNET_SETUP_PATH, HERE)}) in "
        f"{results['load_s']:.3f} s, one g1_fixedbase_table launch")
    try:
        results["vectors"] = run_capi_vectors(lib, settings)
        checked, excluded = check_capi(lib, settings, ctx, card)
    finally:
        lib.free_trusted_setup(ctypes.byref(settings))
    launches = {k: n - excluded[k] for k, n in launch_counts().items()}  # the path ends here
    results["timing"] = checked["timing"]
    log(f"  C ABI path launches {launches}")
    missing = [name for name in CAPI_KERNELS if launches[name] == 0]
    if missing:
        raise AssertionError(f"not launched on the C ABI's path: {missing}")
    results["client"] = run_capi_client(checked["client_expected"])
    return results, launches


def in_turns(ways: dict, reps: int) -> tuple:
    """Each of ways' calls (one `host_ms` each) reps times, in turns -> ({way: the first
    result}, {way: {"median_ms", "ms"}}); raises unless every call of
    every way gives the same result."""
    results, times = {}, {way: [] for way in ways}
    for _ in range(reps):
        for way, fn in ways.items():
            out, (ms,) = fn()
            times[way].append(ms)
            if results.setdefault(way, out) != out:
                raise AssertionError(f"{way}: a repeated call gave another result")
    first = next(iter(results.values()))
    if any(out != first for out in results.values()):
        raise AssertionError(f"the ways disagree: {list(ways)}")
    return results, {way: {"median_ms": statistics.median(ms), "ms": ms} for way, ms in times.items()}


def native_phase(ctx, blobs, commitments, proofs, card: str) -> dict:
    """Phase 13: the native tier on the card's host. verify_kzg_proof on
    the default context with the tier on and with LWKZG_NATIVE=0, the G2
    stage of a mainnet conversion both ways, and the three sizes a CPU
    backend sends to the tier (12 decompressions, the three linear combinations
    of a batch of 6, 6 blob evaluations) natively and on the card, each
    in turns, medians of NATIVE_REPS, equal results."""
    from lambdaworks_kzg_tpu_torch import native
    from lambdaworks_kzg_tpu_torch.constants import R
    from lambdaworks_kzg_tpu_torch.host import curve as HC
    from lambdaworks_kzg_tpu_torch.models import srs
    from lambdaworks_kzg_tpu_torch.utils import hashing as H
    from lambdaworks_kzg_tpu_torch.utils.yaml_vectors import load_case

    out = {}
    fn = "verify_kzg_proof"
    for name in sorted(os.listdir(os.path.join(CONSENSUS, fn, "small"))):  # a true check of
        case = load_case(os.path.join(CONSENSUS, fn, "small", name, "data.yaml"))  # finite points
        args = [case["input"][a] for a in VECTOR_ARGS[fn]]
        if case["output"] is True and args[0][0] != 0xC0 and args[3][0] != 0xC0:
            break

    def verify_off():
        with native_off():
            return host_ms(lambda: ctx.verify_kzg_proof(*args))

    verdicts, out["verify_kzg_proof"] = in_turns(
        {"native": lambda: host_ms(lambda: ctx.verify_kzg_proof(*args)), "off": verify_off}, NATIVE_REPS)
    if verdicts["native"] is not True:
        raise AssertionError(f"{name}: verify_kzg_proof gave {verdicts['native']}")
    log(f"  verify_kzg_proof ({name}) on the default context: "
        f"{out['verify_kzg_proof']['native']['median_ms']:.2f} ms with the native tier, "
        f"{out['verify_kzg_proof']['off']['median_ms']:.2f} ms with LWKZG_NATIVE=0 (medians of "
        f"{NATIVE_REPS}; {card})")

    with open(srs.MAINNET_SETUP_PATH, encoding="utf-8") as f:
        _, g2_bytes = srs._parse_setup_text(f.read())

    def g2_off():
        with native_off():
            return host_ms(lambda: srs._decompress_g2_list(g2_bytes))

    _, out["g2_stage"] = in_turns(
        {"native": lambda: host_ms(lambda: srs._decompress_g2_list(g2_bytes)), "off": g2_off},
        NATIVE_REPS)
    log(f"  the conversion's G2 stage ({len(g2_bytes)} points): "
        f"{out['g2_stage']['native']['median_ms']:.2f} ms native, "
        f"{out['g2_stage']['off']['median_ms']:.2f} ms in Python ints (PERF.md had 185-297 ms)")

    compressed = list(commitments) + list(proofs)
    _, out["decompress_12"] = in_turns({
        "native": lambda: host_ms(lambda: [native.g1_decompress(b) for b in compressed]),
        "card": lambda: host_ms(lambda: [HC.to_affine(pt)
                                         for pt in ctx.backend.decompress_g1_batch(compressed)]),
    }, NATIVE_REPS)
    n = ctx.n
    zs = [H.compute_challenge(b, c, n) for b, c in zip(blobs, commitments)]
    rows, affine = batch_msm_inputs(ctx, blobs, commitments, proofs)
    weighted = [[(k % R, pt) for k, pt in zip(row, affine) if k % R] for row in rows]
    _, out["msm_6_6_7"] = in_turns({  # the card's: one batch of three MSMs over 13 points
        "native": lambda: host_ms(lambda: [native.g1_msm_affine(*map(list, zip(*pairs)))
                                           for pairs in weighted]),
        "card": lambda: host_ms(lambda: [HC.to_affine(p) for p in ctx.backend.msm_batch(rows, affine)]),
    }, NATIVE_REPS)
    roots = ctx.backend.domain.roots_brp_le
    _, out["evaluate_6"] = in_turns({  # the card's: one fr_evaluate launch
        "native": lambda: host_ms(lambda: [native.blob_eval(b, roots, n, z) for b, z in zip(blobs, zs)]),
        "card": lambda: host_ms(lambda: ctx.backend.evaluate_blobs(blobs, zs)),
    }, NATIVE_REPS)
    for key, what in (("decompress_12", "12 decompressions (+ subgroup checks)"),
                      ("msm_6_6_7", "the three linear combinations of a batch of 6 (natively 6, 6, 7 "
                                    "points; on the card one batch of three MSMs over 13)"),
                      ("evaluate_6", "6 blob evaluations (fr_evaluate on the card)")):
        log(f"  {what}: native {out[key]['native']['median_ms']:.3f} ms, card "
            f"{out[key]['card']['median_ms']:.3f} ms (medians of {NATIVE_REPS}, equal results)")
    return out


def distributed_job(backend: str, commit_set, verify_set, ntt_set) -> dict:
    """What every rank of phase 14 is given: the blobs and what phases 6
    and 8 gave for them, and phase 3c's NTT input and results."""
    blobs, commitments = commit_set
    vblobs, vcs, vps = verify_set
    values, (forward, inverse) = ntt_set
    return {"backend": backend, "blobs": [b.hex() for b in blobs],
            "commitments": [c.hex() for c in commitments],
            "verify_blobs": [b.hex() for b in vblobs], "verify_commitments": [c.hex() for c in vcs],
            "verify_proofs": [p.hex() for p in vps],
            "ntt": {"values": values, "forward": forward, "inverse": inverse}}


def rank_worker(coord: str, world: int, rank: int, job_path: str) -> int:
    """One rank of phase 14 (`chip_smoke.py --rank ...`): initialize the
    process group, then on the mainnet setup a commitment with the points
    axis across the ranks, a batch of 6 commitments and a batch
    verification of 6 (true, and false with proofs 0 and 1 swapped) with
    the data axis across them, and the NTT at n = 4096 and its inverse
    with each axis across them (`parallel/ntt.py`), each equal to the
    job's; prints one RANK_RESULT line with the times and this rank's
    launches."""
    import torch

    from lambdaworks_kzg_tpu_torch import EIP4844Context, load_mainnet_setup
    from lambdaworks_kzg_tpu_torch.ops import kernels
    from lambdaworks_kzg_tpu_torch.parallel import distributed
    from lambdaworks_kzg_tpu_torch.parallel.ntt import sharded_ntt_ints

    with open(job_path) as f:
        job = json.load(f)
    blobs = [bytes.fromhex(b) for b in job["blobs"]]
    want = [bytes.fromhex(c) for c in job["commitments"]]
    vblobs = [bytes.fromhex(b) for b in job["verify_blobs"]]
    vcs = [bytes.fromhex(c) for c in job["verify_commitments"]]
    vps = [bytes.fromhex(p) for p in job["verify_proofs"]]
    t0 = time.perf_counter()
    if distributed.initialize(coord, world, rank) is not True:
        raise AssertionError("initialize() did not join the group")
    backend = torch.distributed.get_backend()
    if backend != job["backend"]:
        raise AssertionError(f"the group chose {backend}, not {job['backend']}")
    times = {"initialize_s": time.perf_counter() - t0}
    setup = load_mainnet_setup()
    kernels.reset_counts()  # this rank's distributed path starts here
    points_mesh = distributed.global_mesh(data=1, points=world)
    data_mesh = distributed.global_mesh()
    ctx_points, (times["context_points_ms"],) = host_ms(lambda: EIP4844Context(setup, mesh=points_mesh))
    ctx_data, (times["context_data_ms"],) = host_ms(lambda: EIP4844Context(setup, mesh=data_mesh))
    single, (times["commit_points_ms"],) = host_ms(lambda: ctx_points.blob_to_kzg_commitment(blobs[0]))
    batch, (times["commit_batch6_ms"],) = host_ms(lambda: ctx_data.blob_to_kzg_commitment_batch(blobs))
    ok, (times["verify_batch6_true_ms"],) = host_ms(
        lambda: ctx_data.verify_blob_kzg_proof_batch(vblobs, vcs, vps))
    bad, (times["verify_batch6_false_ms"],) = host_ms(
        lambda: ctx_data.verify_blob_kzg_proof_batch(vblobs, vcs, [vps[1], vps[0]] + vps[2:]))
    ntt_job = job["ntt"]
    for axis, mesh in (("data", data_mesh), ("points", points_mesh)):
        for direction in ("forward", "inverse"):
            got, (times[f"ntt_{axis}_{direction}_ms"],) = host_ms(
                lambda: sharded_ntt_ints(mesh, axis, ntt_job["values"], direction == "inverse"))
            if got != ntt_job[direction]:
                raise AssertionError(f"rank {rank} of {world}: the {direction} NTT with the {axis} "
                                     "axis across the ranks differs from phase 3c's")
    launches = launch_counts()  # the path ends here
    if single != want[0] or batch != want or ok is not True or bad is not False:
        raise AssertionError(f"rank {rank} of {world}: commitment {single == want[0]}, batch "
                             f"{batch == want}, verdicts {ok} / {bad}")
    print("RANK_RESULT " + json.dumps({
        "rank": rank, "world": world, "backend": backend, "meshes": [points_mesh.shape, data_mesh.shape],
        "commitment": single.hex(), "batch": [c.hex() for c in batch], "verdicts": [ok, bad],
        "times": times, "launches": launches}), flush=True)
    torch.distributed.barrier()  # no rank leaves while another still talks to it
    torch.distributed.destroy_process_group()
    return 0


def run_world(world: int, job: dict, tmp: str) -> list:
    """World ranks of `rank_worker` at once on a free localhost port ->
    their RANK_RESULT objects; any rank that fails (or a deadline of
    DIST_TIMEOUT_S) kills the others and fails the phase."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    job_path = os.path.join(tmp, f"job_{world}.json")
    with open(job_path, "w") as f:
        json.dump(job, f)
    logs = [open(os.path.join(tmp, f"rank_{world}_{r}.log"), "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", f"localhost:{port}",
                               str(world), str(r), job_path], stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    deadline = time.perf_counter() + DIST_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if failed or time.perf_counter() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    results = []
    for r, (p, text) in enumerate(zip(procs, outs)):
        lines = [line for line in text.splitlines() if line.startswith("RANK_RESULT ")]
        if p.returncode != 0 or len(lines) != 1:
            raise AssertionError(f"rank {r} of {world} exited {p.returncode}:\n" + text[-6000:])
        results.append(json.loads(lines[0][len("RANK_RESULT "):]))
    return results


def distributed_phase(commit_set, verify_set, ntt_set, card: str) -> tuple:
    """Phase 14: world size 1 on nccl, then 2 and 4 ranks on gloo sharing
    the card (NCCL refuses two ranks on one card), each rank a
    `rank_worker` process. -> (results, the launches of every rank of
    every world summed)."""
    tmp = tempfile.mkdtemp(prefix="lwkzg_dist_")
    out, launches = {}, {}
    try:
        for world, backend in DIST_WORLDS:
            t0 = time.perf_counter()
            ranks = run_world(world, distributed_job(backend, commit_set, verify_set, ntt_set), tmp)
            seconds = time.perf_counter() - t0
            firsts = {(r["commitment"], tuple(r["batch"]), tuple(r["verdicts"])) for r in ranks}
            if len(firsts) != 1:
                raise AssertionError(f"world {world}: the ranks disagree")
            for r in ranks:
                for name, n in r["launches"].items():
                    launches[name] = launches.get(name, 0) + n
                log(f"  world {world} ({backend}) rank {r['rank']}: meshes {r['meshes']}, equal to "
                    f"phases 6, 8 and 3c (the NTT); times {r['times']}; launches "
                    f"{ {k: n for k, n in r['launches'].items() if n} }")
            out[f"world_{world}"] = {"backend": backend, "seconds": seconds,
                                     "ranks": [{"rank": r["rank"], "times": r["times"],
                                                "launches": r["launches"]} for r in ranks]}
            log(f"  world {world}: {world} processes in {seconds:.2f} s ({card})")
    finally:
        shutil.rmtree(tmp)
    missing = [name for name in DIST_KERNELS if launches.get(name, 0) == 0]
    if missing:
        raise AssertionError(f"not launched on the distributed path: {missing} ({launches})")
    return out, launches


def generic_msm_phase(setup, dev, card: str) -> tuple:
    """Phase 15: `ops/msm.msm_device` (JAX's windowed generic MSM: the
    window sums, then one g1_window_combine; no table) at
    GENERIC_MSM_SHAPES on tensors on the card, over the 4096 mainnet
    Lagrange points tiled n / 4096 times, with seeded scalars below
    2^scalar_bits (r for 255). The oracle shares no MSM code: the
    4096-point MSM of each point's scalars summed mod r, on the native
    tier, compared in affine form. Tiling sends equal points into one
    bucket, so the accumulation's doubling fix-up runs hard. Per shape:
    the checked run's ms, launches and peak of
    `torch.cuda.max_memory_allocated`, then the MSM again, and its device
    time by stage under the profiler (`msm_stages`); then the route before it, the table
    build (`dispatch.fixedbase_table`) and `msm_fixedbase_device` over
    it, timed apart with its own peak and result, for the comparison in
    one process; then the 2^20 MSM's 255-bit / 248-bit time. -> (results,
    the checked runs' launches summed)."""
    import numpy as np
    import torch

    from lambdaworks_kzg_tpu_torch import native
    from lambdaworks_kzg_tpu_torch.constants import R
    from lambdaworks_kzg_tpu_torch.host import curve as HC
    from lambdaworks_kzg_tpu_torch.ops import dispatch, g1_ops, kernels, limbs as lb, msm

    basis = basis_affine(setup)
    n_basis = len(basis)
    points = lb.as_limb_tensor(setup.lagrange_points, dev)
    valid = torch.from_numpy(setup.lagrange_valid.copy()).to(dev)
    out, total = {}, {}

    def affine_of(pt):
        return HC.to_affine(g1_ops.points_to_host(dispatch.from_op_layout(pt))[0])

    for n, c, bits in GENERIC_MSM_SHAPES:
        tiles = n // n_basis
        rng = np.random.default_rng(n + bits)
        limbs = rng.integers(0, 1 << 16, size=(16, n), dtype=np.int64)
        # the top limb below r's (0x73ed), or below 2^(bits - 240)
        limbs[15] = rng.integers(0, 0x73ED if bits == 255 else 1 << (bits - 240), size=n)
        sums = limbs.reshape(16, tiles, n_basis).sum(axis=1)
        folded = [sum(int(sums[k, i]) << (16 * k) for k in range(16)) % R for i in range(n_basis)]
        want = native.g1_msm_affine(folded, basis)
        pts, ok = points.repeat(1, 1, tiles), valid.repeat(tiles)
        scalars = torch.from_numpy(limbs).to(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()  # this shape's path starts here
        got, msm_device_ms = events_ms(lambda: msm.msm_device(pts, ok, scalars, c, scalar_bits=bits))
        launches = launch_counts()  # and ends here
        peak = torch.cuda.max_memory_allocated()
        if affine_of(got) != want:
            raise AssertionError(f"the generic MSM at n={n} c={c} bits={bits} differs from its oracle")
        expect_launches(f"the generic MSM at n={n}", dict.fromkeys(launches, 0), GENERIC_LAUNCHES)
        del got
        _, again_ms = events_ms(lambda: msm.msm_device(pts, ok, scalars, c, scalar_bits=bits))
        stages = msm_stages(lambda: msm.msm_device(pts, ok, scalars, c, scalar_bits=bits))
        # the route before this one, for comparison: a table for the call
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        (table, table_valid), table_ms = events_ms(lambda: dispatch.fixedbase_table(pts, ok, c))
        old, msm_ms = events_ms(lambda: msm.msm_fixedbase_device(table, table_valid, scalars, c))
        old_peak = torch.cuda.max_memory_allocated()
        if affine_of(old) != want:
            raise AssertionError(f"the table route at n={n} differs from its oracle")
        del table, table_valid, old
        for name, k in launches.items():
            total[name] = total.get(name, 0) + k
        key = f"n{n}_c{c}_b{bits}"
        out[key] = {"n": n, "c": c, "scalar_bits": bits, "msm_device_ms": [msm_device_ms, again_ms],
                    "stages_device_ms": stages, "peak_bytes": peak,
                    "launches": {name: k for name, k in launches.items() if k},
                    "table_route": {"table_ms": table_ms, "msm_ms": msm_ms,
                                    "total_ms": table_ms + msm_ms, "peak_bytes": old_peak}}
        log(f"  n=2^{n.bit_length() - 1} c={c} scalar_bits={bits}: equal to the native oracle "
            f"({n_basis} points, scalars folded mod r); msm_device {msm_device_ms:.2f} / "
            f"{again_ms:.2f} ms (CUDA events), stages {stages}, launches {out[key]['launches']}, "
            f"peak {peak / 2**30:.3f} GiB; the table route: table {table_ms:.2f} ms + MSM "
            f"{msm_ms:.2f} ms, peak {old_peak / 2**30:.3f} GiB ({card})")
    full, short = (out.get(f"n{1 << 20}_c12_b{bits}") for bits in (255, 248))
    if full and short:  # the 255-bit top window against a full one at 248 bits
        out["ratio_255_to_248"] = full["msm_device_ms"][1] / short["msm_device_ms"][1]
        log(f"  n=2^20 c=12: msm_device 255-bit / 248-bit = {out['ratio_255_to_248']:.3f} "
            f"({full['msm_device_ms'][1]:.2f} / {short['msm_device_ms'][1]:.2f} ms, one process) "
            f"({card})")
    missing = [name for name in GENERIC_KERNELS if total.get(name, 0) == 0]
    if missing:
        raise AssertionError(f"not launched on the generic MSM path: {missing}")
    return out, total


def fuzz_phase(card: str) -> tuple:
    """Phase 16: `fuzz/fuzz_differential.py` for FUZZ_ITERS iterations on
    the degree-4 setup, converted on the card (the ways cpu, card, card
    with LWKZG_NATIVE=0 and card with the host pairing tier must agree;
    any finding fails the phase); then
    `fuzz/gen_corpus.py` on the card and the combined C target of
    `fuzz/fuzz_capi.c` (replay mode, gcc) on every generated seed and
    every FUZZ_VECTOR_STRIDE-th consensus-vector seed, with
    LWKZG_BACKEND=device: its contexts run on the card, and a call that
    returns C_KZG_ERROR or C_KZG_MALLOC fails the phase. -> (results, the
    differential's launches in this process; the C program's are its
    own)."""
    import torch

    from lambdaworks_kzg_tpu_torch import capi
    from lambdaworks_kzg_tpu_torch.fuzz import fuzz_differential, gen_corpus
    from lambdaworks_kzg_tpu_torch.ops import kernels

    tmp = tempfile.mkdtemp(prefix="lwkzg_fuzz_")
    try:
        kernels.reset_counts()  # the fuzz path starts here
        t0 = time.perf_counter()
        fuzzer = fuzz_differential.run(FUZZ_ITERS, FUZZ_SEED, device="cuda", cache_dir=tmp, log=log)
        torch.cuda.synchronize()
        launches = launch_counts()  # and ends here
        out = {"differential": {"iterations": fuzzer.iterations, "cases": len(fuzzer.cases),
                                "calls": fuzzer.calls, "findings": len(fuzzer.findings),
                                "s": time.perf_counter() - t0}}
        for line in fuzzer.findings:
            log("  " + line)
        log(f"  differential: {out['differential']}; launches "
            f"{ {k: n for k, n in launches.items() if n} }")
        if fuzzer.findings:
            raise AssertionError(f"the differential fuzzer found {len(fuzzer.findings)} faults")
        corpus = os.path.join(tmp, "corpus")
        t0 = time.perf_counter()
        n_vectors = gen_corpus.corpus_from_vectors(corpus)
        gen_corpus.corpus_from_library(corpus, 1, FUZZ_SEED, device="cuda", cache_dir=tmp)
        ours, vectors = gen_corpus.combined_corpus(corpus)
        picked = ours + sorted(vectors)[::FUZZ_VECTOR_STRIDE]
        corpus_s = time.perf_counter() - t0
        built = capi.build_fuzz()
        env = capi.client_env()
        env["LWKZG_BACKEND"] = "device"
        t0 = time.perf_counter()
        proc = subprocess.run([built["path"], *picked], env=env, capture_output=True, text=True,
                              timeout=FUZZ_C_TIMEOUT_S)
        replay_s = time.perf_counter() - t0
        summary = [line for line in proc.stderr.splitlines() if line.startswith("replayed ")]
        out["c_replay"] = {"files": len(picked), "generated_files": len(ours), "vector_seeds": n_vectors,
                           "corpus_s": corpus_s, "build_s": built["seconds"], "s": replay_s,
                           "summary": summary}
        log(f"  the combined C target (LWKZG_BACKEND=device) on {len(picked)} seeds "
            f"({len(ours)} generated on the card): exit {proc.returncode}, {summary}, {replay_s:.1f} s; "
            f"corpus {corpus_s:.1f} s ({card})")
        if (proc.returncode != 0 or len(summary) != 1
                or not summary[0].startswith(f"replayed {len(picked)} corpus files:")
                or not summary[0].endswith(" 0 internal errors")):
            raise AssertionError(f"the C target failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    finally:
        shutil.rmtree(tmp)
    return out, launches


def bench_phase(device: dict, card: str) -> tuple:
    """Phase 17: `python3 -m lambdaworks_kzg_tpu_torch.bench --reps
    BENCH_REPS` in a process of its own (killed after BENCH_TIMEOUT_S), on
    phase 2's `_build/`. It must exit 0 with its last stdout line one JSON
    object without `error`, on this card (`device`), with `_build/` warm,
    every block of BASELINE.json's configurations `ok` (the sweep not run)
    and every time, rate and ratio finite and positive (`bench.timed_values`),
    each of BENCH_KERNELS launched. -> (the line, the bench's launches over
    its run)."""
    import math

    from lambdaworks_kzg_tpu_torch import bench

    proc = subprocess.run([sys.executable, "-m", f"{PKG}.bench", "--reps", str(BENCH_REPS)], cwd=HERE,
                          capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    for text in proc.stderr.splitlines():
        log("  " + text)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"the bench exited {proc.returncode}; its last line: "
                             f"{lines[-1] if lines else None}")
    line = json.loads(lines[-1])
    log(f"  {json.dumps(line)}")
    if "error" in line:
        raise AssertionError(f"the bench's line has an error: {line['error']}")
    if line.get("device") != device or line.get("card") != card:
        raise AssertionError(f"the bench ran on {line.get('device')} ({line.get('card')}), not {device}")
    if line.get("build_warm") is not True:
        raise AssertionError("the bench built its kernels again: phase 2's _build/ was not warm")
    configs = line["configs"]
    not_ok = [name for name in bench.CONFIGS if configs[name]["ok"] is not True]
    if not_ok or configs[bench.SWEEP]["run"] is not False:
        raise AssertionError(f"the bench's configurations not ok: {not_ok}; the sweep {configs[bench.SWEEP]}")
    bad = [key for key, v in bench.timed_values(line)
           if not (isinstance(v, (int, float)) and math.isfinite(v) and v > 0)]
    if bad:
        raise AssertionError(f"the bench's line: not a finite positive number: {bad}")
    missing = [name for name in BENCH_KERNELS if line["launches"].get(name, 0) == 0]
    if missing:
        raise AssertionError(f"not launched on the bench's path: {missing}")
    log(f"  the bench: {line['value']:.3f} ms/blob, {line['msm_2e20_pps']:.0f} points/s at 2^20 "
        f"(c = {line['msm_2e20_c']}), batch of 64 {configs[bench.CONFIGS[3]]['ms_per_blob']:.3f} ms "
        f"a blob, {BENCH_REPS} reps ({card})")
    return line, line["launches"]


def run() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this run needs an NVIDIA card")

    from lambdaworks_kzg_tpu_torch import (EIP4844Context, KZGConfig, KZGError, convert,
                                           load_mainnet_setup, load_trusted_setup_file, native)
    from lambdaworks_kzg_tpu_torch.models import kzg as kzg_module, srs
    from lambdaworks_kzg_tpu_torch.constants import P, R, num_windows
    from lambdaworks_kzg_tpu_torch.host import curve as HC
    from lambdaworks_kzg_tpu_torch.ops import (codec, dispatch, g1_batch, g1_ops, kernels, limbs as lb,
                                               msm, pairing_ops)
    from lambdaworks_kzg_tpu_torch.ops.field_ops import FP
    from lambdaworks_kzg_tpu_torch.utils import hashing as H
    from lambdaworks_kzg_tpu_torch.utils.profiling import collect_kernel_stats, roofline_table
    from lambdaworks_kzg_tpu_torch.utils.yaml_vectors import load_commitment_vector

    dev = torch.device("cuda", 0)
    results = {}

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    with Phase("1 card"):
        card = card_line()
        log(card)
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    with Phase("2 build"):
        with ThreadPoolExecutor(1) as pool:  # g++ for the native tier beside nvcc
            native_build = pool.submit(native.build)
            info = kernels.build()
            built_native = native_build.result()
        results["build_s"] = info["seconds"]
        results["native_build_s"] = built_native["seconds"]
        log(f"nvcc build {info['seconds']:.2f} s -> {os.path.relpath(info['library'], HERE)}")
        log(f"g++ build of the native tier {built_native['seconds']:.2f} s -> "
            f"{os.path.relpath(built_native['library'], HERE)}")
        if not native.available():
            raise AssertionError("the native tier is off: this run needs it (LWKZG_NATIVE unset)")
        for line in info["log"].splitlines():
            if "Function properties for" in line or "registers" in line or "spill" in line:
                log("  " + line.strip())
        pairing_report = pairing_levels_report()
        for name in pairing_report:
            pairing_report[name]["ptxas"] = ptxas_report(info["log"], name + "_kernel")
            log(f"  {name}: {pairing_report[name]}")
        fr_report = {name: ptxas_report(info["log"], name + "_kernel", calls=True)
                     for name in ("fr_evaluate_cluster", "fr_evaluate", "fr_quotient",
                                  "fr_quotient_in_domain_cluster", "fr_quotient_in_domain")}
        for name, rep in fr_report.items():  # no Fermat chain on the card for these three
            log(f"  {name}: ptxas {rep}")
            if "registers" not in rep or any("fr3inv" in c for c in rep["calls"]):
                raise AssertionError(f"{name}: ptxas reports a call of fr::inv or no entry: {rep}")
        results["fr_ptxas"] = fr_report
        # g1_fold_kernel on the public limbs (g1_fold) and on two u32 rows (g1_add)
        results["fold_ptxas"] = {name: ptxas_report(info["log"], rows)
                                 for name, rows in (("g1_fold", "LimbRows"), ("g1_add", "WordRows"))}
        log(f"  g1_fold and g1_add: ptxas {results['fold_ptxas']}")

    setup = load_mainnet_setup()
    points = lb.as_limb_tensor(setup.lagrange_points, dev)
    points_valid = torch.from_numpy(setup.lagrange_valid.copy()).to(dev)
    max_err = {k.name: 0 for k in kernels.ALL + (kernels.sqr_check, kernels.coop_check, kernels.fr_check)}
    with Phase("3 kernels vs plain"):
        check_sqr(dev, 4096, seed=5)
        max_err["fp_coop_check"] = check_coop(dev, 4096, seed=6)
        lane = torch.arange(256, device=dev)
        for c in (4, 8):
            err, _, _ = check_table(f"c={c} N=256, every 7th lane invalid", points[:, :, :256],
                                    points_valid[:256] & (lane % 7 != 3), c)
            max_err["g1_fixedbase_table"] = max(max_err["g1_fixedbase_table"], err)
        err, table_kernel_ms, table_plain_ms = check_table(
            f"c={C_MAIN} N={points.shape[-1]} (mainnet)", points, points_valid, C_MAIN)
        max_err["g1_fixedbase_table"] = max(max_err["g1_fixedbase_table"], err)
        for M in CHECK_LANES:
            p, q, live, q3 = make_lanes(points, M, seed=M)
            for op, args in (("madd", (p, q, live)), ("add", (p, q3)), ("dbl", (p,))):
                name = getattr(kernels, op).name
                max_err[name] = max(max_err[name], check_kernel(op, args))
                log(f"  {op} M={M}: equal to plain, limb for limb")
        fold_checked = check_fold(points, max_err)
        table16, table_valid = convert.fixedbase_from_npz(FIXEDBASE, dev)
        rng = np.random.default_rng(3)
        for n_blobs in (1, 6):
            order, bstart = blob_members(table_valid, random_blobs(rng, n_blobs), C_MAIN)
            check_msm_kernels(f"mainnet c={C_MAIN} B={n_blobs}", table16, order, bstart, C_MAIN,
                              max_err)
        for name, blob in skewed_blobs().items():
            order, bstart = blob_members(table_valid, [blob], C_MAIN)
            check_msm_kernels(f"mainnet c={C_MAIN} B=1, {name}", table16, order, bstart, C_MAIN,
                              max_err)
        for c, n_blobs in ((4, 2), (12, 1)):
            synth, order, bstart = synthetic_table(points, 4096, c, n_blobs, seed=c)
            extra = synthetic_partials(points, bstart, order.shape[1], c, chunk_length(*order.shape),
                                       seed=c)
            check_msm_kernels(f"synthetic c={c} B={n_blobs}", synth, order, bstart, c, max_err,
                              extra_partials=extra)
        q_order, q_bstart = check_real_quotient(setup, table16, table_valid, max_err)
        combine_checked = check_window_combine(points, max_err)
        batch_plain_ms = check_batch_kernels(setup, dev, max_err)
        pairing_checked = check_pairing_kernels(dev, max_err)
        fr_checked = check_fr_kernels(dev, max_err)

    kernels.reset_counts()  # the conversion path starts here
    with Phase("3b setup conversion"):
        tmp = tempfile.mkdtemp(prefix="lwkzg_srs_")
        try:
            t0 = time.perf_counter()
            converted = load_trusted_setup_file(srs.MAINNET_SETUP_PATH, cache_dir=tmp, device="cuda")
            torch.cuda.synchronize()
            results["convert_s"] = time.perf_counter() - t0
            convert_launches = launch_counts()  # the path ends here
            expected = {k.name: CONVERT_LAUNCHES.get(k.name, 0) for k in kernels.ALL}
            if convert_launches != expected:
                raise AssertionError(f"the conversion's launches are {convert_launches}, not {expected}")
            same_npz(os.path.join(tmp, "srs_mainnet.npz"), SRS_MAINNET)
            if not (np.array_equal(converted.lagrange_points, setup.lagrange_points)
                    and converted.g1_monomial == setup.g1_monomial
                    and converted.g2_monomial == setup.g2_monomial):
                raise AssertionError("the converted setup differs from the committed one")
            log(f"  mainnet setup converted on the card in {results['convert_s']:.3f} s, "
                f"lagrange, monomial and g2 byte-equal to {os.path.relpath(SRS_MAINNET, HERE)}; "
                f"launches {convert_launches}")
            results["convert_stages"] = [convert_stages(srs.MAINNET_SETUP_PATH, dev) for _ in range(2)]
            log(f"  stages (two runs): {results['convert_stages']}")
            load_trusted_setup_file(SETUP_4, cache_dir=tmp, device="cuda")
            same_npz(os.path.join(tmp, SRS_4_NAME), host_conversion(SETUP_4))
            log(f"  degree-4 setup converted on the card into {SRS_4_NAME}, byte-equal to its "
                "conversion by the host oracles")
        finally:
            shutil.rmtree(tmp)

    with Phase("3c NTT"):
        results["ntt"], ntt_set = check_ntt(dev)

    kernels.reset_counts()
    with Phase("4 setup and fixed-base table"):
        t0 = time.perf_counter()
        ctx = EIP4844Context(converted, device="cuda")
        torch.cuda.synchronize()
        results["table_build_s"] = time.perf_counter() - t0
        results["table_kernel_ms_phase3"] = table_kernel_ms
        built = launch_counts()
        if built["g1_fixedbase_table"] != 1 or built["g1_dbl"] != 0:
            raise AssertionError(f"one table build must launch g1_fixedbase_table once and g1_dbl "
                                 f"never ({built})")
        table, valid = ctx.backend.fixedbase()
        with np.load(FIXEDBASE) as ref:
            same_table = np.array_equal(table.cpu().numpy().astype(np.uint32), ref["table"])
            same_valid = np.array_equal(valid.cpu().numpy(), ref["valid"])
        if not (same_table and same_valid):
            raise AssertionError(f"fixed-base table differs (table {same_table}, valid {same_valid})")
        log(f"  table {tuple(table.shape)} built in {results['table_build_s']:.4f} s (the kernel "
            f"alone {table_kernel_ms:.3f} ms, phase 3, CUDA events), bit-equal to "
            f"{os.path.relpath(FIXEDBASE, HERE)}; one g1_fixedbase_table launch, no g1_dbl launch")

    with Phase("5 consensus vectors"):
        names = sorted(os.listdir(VECTORS))
        passed = 0
        for name in names:
            blob, want = load_commitment_vector(os.path.join(VECTORS, name, "data.yaml"))
            t0 = time.perf_counter()
            try:
                got = ctx.blob_to_kzg_commitment(blob)
            except KZGError:
                got = None
            ok = got == want
            passed += ok
            log(f"  {name}: {'ok' if ok else 'WRONG'} ({time.perf_counter() - t0:.3f} s)")
        if passed != len(names) or len(names) != 10:
            raise AssertionError(f"{passed}/{len(names)} vectors correct")
        log(f"  {passed}/{len(names)} blob_to_kzg_commitment vectors correct")

    with Phase("6 batch of six blobs"):
        rng = np.random.default_rng(4844)
        blobs = random_blobs(rng, 6)
        runs = [timed_call(ctx.blob_to_kzg_commitment, b) for b in blobs[:3]]
        singles = [r[0] for r in runs]
        results["ms_per_blob_single"] = [r[1] for r in runs]
        runs = [timed_call(ctx.blob_to_kzg_commitment_batch, blobs) for _ in range(2)]
        batch = runs[0][0]
        results["ms_per_blob_batch6"] = [r[1] / len(blobs) for r in runs]
        launches = launch_counts()  # the main path ends here
        log(f"  single {results['ms_per_blob_single']} ms/blob, "
            f"batch of 6 {results['ms_per_blob_batch6']} ms/blob; launches {launches}; "
            "each commit and each batch launched each MSM kernel once")
        if singles != batch[:3] or runs[1][0] != batch or len(set(batch)) != len(batch):
            raise AssertionError("batch and single commitments disagree")
        scalars = lb.as_limb_tensor(codec.blob_to_limbs(blobs[1], 4096), dev)
        t0 = time.perf_counter()
        plain = HC.compress_g1(ctx.backend.commit_scalars(scalars, ops=g1_ops))
        log(f"  plain PyTorch path on the card: {time.perf_counter() - t0:.2f} s")
        if plain != batch[1]:
            raise AssertionError("kernel path and plain path commit differently")
        log("  blob 1: kernel path equals the plain path on the card")
        missing = [name for name in PATH_KERNELS if launches[name] == 0]
        if missing:
            raise AssertionError(f"not launched on the main path: {missing} ({launches})")
        if launches["g1_fixedbase_table"] != 1 or launches["g1_dbl"] != 0:
            raise AssertionError(f"the main path must launch g1_fixedbase_table once and g1_dbl "
                                 f"never ({launches})")
        commit_set = (blobs, batch)

    with Phase("7 proof vectors"):
        # a subset: phase 12 runs all 58 through the C ABI on this setup
        for fn in ("compute_kzg_proof", "compute_blob_kzg_proof"):
            run_vectors(ctx, fn, valid_cap=PROOF_VECTOR_CAP)

    with Phase("8 verify path"):
        rng = np.random.default_rng(4846)
        batches = {}
        for count in (6, 64):
            blobs = random_blobs(rng, count)
            cs = ctx.blob_to_kzg_commitment_batch(blobs)
            batches[count] = (blobs, cs, ctx.compute_blob_kzg_proof_batch(blobs, cs))
        # count each tier's pairing checks: the host tier's on the native
        # library, or in Python ints with the tier off, and the card's
        tier_checks = {"host": 0, "native": 0, "device": 0}
        pairing_fns = {"host": (kzg_module, "pairings_verify"),
                       "native": (native, "pairings_verify_affine"),
                       "device": (pairing_ops, "pairings_verify_host_points")}
        originals = {tier: getattr(mod, name) for tier, (mod, name) in pairing_fns.items()}

        def counting(tier):
            def pairing(*args):
                tier_checks[tier] += 1
                return originals[tier](*args)
            return pairing

        for tier, (mod, name) in pairing_fns.items():
            setattr(mod, name, counting(tier))
        if not ctx.kzg.device_pairing():
            raise AssertionError("the default context on the card must take the device pairing tier")
        kernels.reset_counts()  # the verify path starts here
        t0 = time.perf_counter()
        for fn in VERIFY_FNS:
            run_vectors(ctx, fn, device_checks=lambda: tier_checks["device"])
        results["verify_vectors_s"] = time.perf_counter() - t0
        vector_checks = tier_checks["device"]
        vector_launches = launch_counts()
        if tier_checks["host"] or tier_checks["native"] or any(
                vector_launches[k] != n * vector_checks for k, n in PAIRING_LAUNCHES.items()):
            raise AssertionError(f"the default verify path made {tier_checks} pairing checks with "
                                 f"launches {vector_launches}")
        log(f"  the 140 verify vectors on the default context: {vector_checks} pairing checks on "
            f"the card, one launch of each pairing kernel per check, no host pairing; the "
            f"decompressions, [y]G1, [z]G2 and single blob evaluations on the native tier")
        results["verify_batch_ms"] = {}
        for count, (blobs, cs, ps) in batches.items():
            swapped = [ps[1], ps[0]] + ps[2:]  # proofs 0 and 1 swapped
            for verdict, proofs in ((True, ps), (False, swapped), (True, ps), (False, swapped)):
                before = launch_counts()
                t0 = time.perf_counter()
                got = ctx.verify_blob_kzg_proof_batch(blobs, cs, proofs)
                ms = (time.perf_counter() - t0) * 1e3
                check_verify_batch_launches(f"{count} seeded blobs", before)
                if got is not verdict:
                    raise AssertionError(f"{count} seeded blobs: verdict {got}, not {verdict}")
                results["verify_batch_ms"].setdefault(f"{count} {verdict}".lower(), []).append(ms)
        verify_launches = launch_counts()  # the verify path ends here
        log(f"  verify_blob_kzg_proof_batch of seeded blobs (true, then proofs 0 and 1 swapped), "
            f"ms per call: {results['verify_batch_ms']}; verify path launches {verify_launches}")
        results["verify_split"] = {count: verify_split(ctx, *batch) for count, batch in batches.items()}
        log(f"  one true batch's stages, ms: {results['verify_split']}")
        results["verify_msm_stages"] = verify_msm_stages(ctx, *batches[6], card)
        missing = [name for name in VERIFY_BATCH_LAUNCHES if verify_launches[name] == 0]
        stray = [name for name, n in verify_launches.items() if n and name not in VERIFY_BATCH_LAUNCHES]
        if missing or stray:
            raise AssertionError(f"the verify path's launches are wrong: {verify_launches}")
        blob, commitment = batches[6][0][0], batches[6][1][0]
        evals = [int.from_bytes(blob[32 * i : 32 * i + 32], "little") for i in range(setup.n)]
        t0 = time.perf_counter()
        point = ctx.backend.msm(evals, basis_affine(setup))
        results["generic_msm_4096_ms"] = (time.perf_counter() - t0) * 1e3
        if HC.compress_g1(point) != commitment:
            raise AssertionError("the generic MSM over the Lagrange basis differs from the commitment")
        log(f"  generic MSM of a blob over the 4096 Lagrange points equals its commitment "
            f"({results['generic_msm_4096_ms']:.1f} ms)")

    with Phase("8b verify path, host pairing tier"):
        ctx_host = EIP4844Context(converted, backend=ctx.backend,
                                  config=KZGConfig(device_pairing=False))
        tier_checks.update(host=0, native=0, device=0)
        kernels.reset_counts()  # the host tier's verify path starts here
        t0 = time.perf_counter()
        for fn in VERIFY_FNS:
            run_vectors(ctx_host, fn, extra=HOST_TIER, device_checks=lambda: tier_checks["device"])
        torch.cuda.synchronize()
        results["verify_vectors_host_pairing_s"] = time.perf_counter() - t0
        host_launches = launch_counts()  # the path ends here
        want = {name: n - vector_checks * PAIRING_LAUNCHES.get(name, 0)
                for name, n in vector_launches.items()}
        if host_launches != want or tier_checks != {"host": 0, "native": vector_checks, "device": 0}:
            raise AssertionError(f"the host tier's launches are {host_launches} with {tier_checks} "
                                 f"pairing checks, not {want} and {vector_checks} native ones")
        log(f"  the 140 verify vectors through KZGConfig(device_pairing=False): all as the "
            f"vectors have them in {results['verify_vectors_host_pairing_s']:.2f} s (device tier "
            f"{results['verify_vectors_s']:.2f} s); {vector_checks} host pairing checks, all on "
            f"the native tier, no pairing kernel; launches {host_launches}")
        # the same verdicts with the native tier off (LWKZG_NATIVE=0):
        # Python-int decompressions, scalar multiplications and pairings
        tier_checks.update(host=0, native=0, device=0)
        t0 = time.perf_counter()
        with native_off():
            off_checks = run_vector_subset(ctx_host, NATIVE_OFF_VECTORS)
        results["verify_vectors_native_off"] = {"vectors": sum(NATIVE_OFF_VECTORS.values()),
                                                "s": time.perf_counter() - t0}
        if tier_checks != {"host": off_checks, "native": 0, "device": 0}:
            raise AssertionError(f"with the native tier off: {tier_checks} pairing checks, not "
                                 f"{off_checks} in Python ints")
        for tier, (mod, name) in pairing_fns.items():
            setattr(mod, name, originals[tier])
        log(f"  {sum(NATIVE_OFF_VECTORS.values())} of them ({NATIVE_OFF_VECTORS}) again with "
            f"LWKZG_NATIVE=0: the same verdicts, {off_checks} pairing checks in Python ints, "
            f"{results['verify_vectors_native_off']['s']:.2f} s")

    with Phase("9 prove path"):
        rng = np.random.default_rng(4845)
        blobs = random_blobs(rng, 6)
        commitments = ctx.blob_to_kzg_commitment_batch(blobs)
        proof_launches = {**MSM_LAUNCHES, **FR_PROOF_LAUNCHES}
        root = ctx.backend.domain.roots_brp_ints[1]
        kernels.reset_counts()  # the prove path starts here
        runs = [timed_call(ctx.compute_blob_kzg_proof, b, c, want=proof_launches)
                for b, c in zip(blobs[:3], commitments[:3])]
        singles = [r[0] for r in runs]
        results["prove_ms_single"] = [r[1] for r in runs]
        runs = [timed_call(ctx.compute_blob_kzg_proof_batch, blobs, commitments, want=proof_launches)
                for _ in range(2)]
        batch = runs[0][0]
        results["prove_ms_per_proof_batch6"] = [r[1] / len(blobs) for r in runs]
        # a proof at a root of unity: the in-domain quotient
        (root_proof, root_y), results["prove_ms_at_root"] = timed_call(
            ctx.compute_kzg_proof, blobs[0], root.to_bytes(32, "little"),
            want={**MSM_LAUNCHES, **FR_ROOT_LAUNCHES})
        prove_launches = launch_counts()  # the prove path ends here
        log(f"  compute_blob_kzg_proof {results['prove_ms_single']} ms per proof, "
            f"batch of 6 {results['prove_ms_per_proof_batch6']} ms per proof, compute_kzg_proof at a "
            f"root {results['prove_ms_at_root']:.3f} ms; launches {prove_launches}; each proof and "
            f"each batch launched {proof_launches}, the proof at a root {FR_ROOT_LAUNCHES} and the "
            f"MSM kernels ({card})")
        if root_y != blobs[0][32:64] or not ctx.verify_kzg_proof(commitments[0], root.to_bytes(32, "little"),
                                                                 root_y, root_proof):
            raise AssertionError("the proof at a root of unity does not verify, or its y is not the "
                                 "stored element")
        if singles != batch[:3] or runs[1][0] != batch or len(set(batch)) != len(batch):
            raise AssertionError("batch and single proofs disagree")
        missing = [name for name in PROVE_KERNELS if prove_launches[name] == 0]
        if missing or prove_launches["g1_fixedbase_table"] != 0:
            raise AssertionError(f"the prove path's launches are wrong: {prove_launches}")
        results["proof_device"] = device_work(lambda: ctx.compute_blob_kzg_proof(blobs[0], commitments[0]))
        log(f"  one compute_blob_kzg_proof under the profiler: {results['proof_device']}")
        zs = [H.compute_challenge(b, c) for b, c in zip(blobs, commitments)]
        split = [prove_split(ctx.backend, blobs[:k], zs[:k]) for k in (1, 6)]
        results["prove_split"] = split
        for sp in split:
            per = sp["blobs"]
            fr_dev, msm_dev = sp["fr_device"], sp["msm_device"] or {}
            log(f"  B={per}: fr_ms {sp['fr_ms']:.3f} (z table, evaluation and quotient; "
                f"{sp['fr_ms'] / per:.3f} per proof; {fr_dev['kernels']} launches and {fr_dev['copies']} copies, "
                f"{FR_PROOF_LAUNCHES} of them Fr kernels, device busy {fr_dev['busy_ms']:.3f} ms), msm_ms {sp['msm_ms']:.3f} (MSM + "
                f"result; {msm_dev.get('kernels', 'not measured')} launches, device busy "
                f"{msm_dev.get('busy_ms', float('nan')):.3f} ms) ({card})")
        results["prove_split_root"] = [root_split(ctx.backend, blobs[0], 1) for _ in range(2)]
        for sp in results["prove_split_root"]:
            dev_rec = sp["fr_device"]
            log(f"  at z = w_1: fr_ms {sp['fr_ms']:.3f} (the root table and the in-domain quotient; "
                f"{dev_rec['kernels']} launches and {dev_rec['copies']} copies, device busy "
                f"{dev_rec['busy_ms']:.4f} ms) ({card})")
        syncs = {"single": host_syncs(lambda: ctx.compute_blob_kzg_proof(blobs[0], commitments[0])),
                 "batch6": host_syncs(lambda: ctx.compute_blob_kzg_proof_batch(blobs, commitments))}
        results["prove_host_syncs"] = syncs
        log(f"  synchronizing calls: {syncs['single']} per proof, {syncs['batch6']} per batch of six")
        prove_set = (blobs, commitments, batch)

    def counted(name: str) -> dict:
        """A kernel's launches on the conversion, commit, verify, prove and
        host-tier verify paths (the mesh path's join after phase 11)."""
        by_path = {"convert": convert_launches.get(name, 0), "commit": launches.get(name, 0),
                   "verify": verify_launches.get(name, 0), "prove": prove_launches.get(name, 0),
                   "verify_host_tier": host_launches.get(name, 0)}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    entries = []
    with Phase("10 kernel timing"):
        rows = dispatch.to_table_layout(table16)
        n_members = rows.shape[0]

        def msm_kernel_times(order, bstart, plain: bool) -> dict:
            """Both MSM kernels on these members at the path's chunk
            length, their plain versions' one call and each one's bound
            from its point ops."""
            n_blobs = order.shape[0]
            chunk = chunk_length(n_blobs, n_members)
            t_acc = time_ms(lambda: kernels.bucket_accumulate(rows, order, bstart, C_MAIN, chunk),
                            reps=10)
            partials = kernels.bucket_accumulate(rows, order, bstart, C_MAIN, chunk)
            partials16 = dispatch.from_table_layout(partials)
            merged16 = g1_ops.merge_chunks(partials16, bstart, C_MAIN, chunk, n_members)
            t_red = time_ms(lambda: kernels.bucket_reduce(partials, bstart, C_MAIN, chunk, n_members),
                            reps=20)  # the merge runs in place: later calls add merged sums again
            p_acc = p_red = None
            if plain:
                p_acc = time_ms(lambda: g1_ops.accumulate_chunks(table16, order, bstart, C_MAIN, chunk),
                                reps=1, warm=0)
                p_red = time_ms(lambda: g1_ops.reduce_chunks(partials16, bstart, C_MAIN, chunk,
                                                             n_members), reps=1, warm=0)
            # the accumulation reads each member's row and order entry and
            # bstart once and writes the partials; the reduce reads the
            # partials of the chunks and bstart and writes B points
            madds, chunks = accumulate_point_ops(order, bstart)
            acc_bytes = n_members * n_blobs * 100 + bstart.numel() * 4 + partials.numel() * 4
            adds, dbls = reduce_point_ops(bstart, n_members, merged16, C_MAIN)
            red_bytes = chunks * 3 * FP_BYTES + bstart.numel() * 4 + n_blobs * 3 * FP_BYTES
            log(f"  B={n_blobs}: accumulate {madds} madds + {chunks} lifts ({chunks} chunks of at most "
                f"{chunk}); reduce {adds} adds + {dbls} doublings of finite points")
            out = {}
            for name, ms, plain_ms, nbytes, imads in (
                ("g1_bucket_accumulate", t_acc, p_acc, acc_bytes, madds * op_imads("madd")),
                ("g1_bucket_reduce", t_red, p_red, red_bytes,
                 adds * op_imads("add") + dbls * op_imads("dbl")),
            ):
                out[name] = {"ms": ms, "plain_ms": plain_ms, **bound(nbytes, imads), "chunk": chunk}
                log(f"  {name} B={n_blobs}: kernel {ms:.4f} ms, plain "
                    f"{'-' if plain_ms is None else f'{plain_ms:.2f}'} ms, bound "
                    f"{out[name]['bound_ms']:.5f} ms ({card})")
            return out

        msm_times = {}
        for n_blobs in (1, 6):
            order, bstart = blob_members(table_valid, random_blobs(rng, n_blobs), C_MAIN)
            msm_times[n_blobs] = msm_kernel_times(order, bstart, plain=True)
        # one random blob again beside the blobs whose digits crowd into
        # one bucket, at B = 1 in one run
        skew = {"random": msm_kernel_times(*blob_members(table_valid, random_blobs(rng, 1), C_MAIN),
                                           plain=False)}
        for name, blob in skewed_blobs().items():
            skew[name] = msm_kernel_times(*blob_members(table_valid, [blob], C_MAIN), plain=False)
        for name in skew:
            ratio = {k: skew[name][k]["ms"] / skew["random"][k]["ms"] for k in skew[name]}
            skew[name]["ratio_to_random"] = ratio
            log(f"  B=1 {name}: accumulate {skew[name]['g1_bucket_accumulate']['ms']:.4f} ms "
                f"({ratio['g1_bucket_accumulate']:.2f}x a random blob's), reduce "
                f"{skew[name]['g1_bucket_reduce']['ms']:.4f} ms "
                f"({ratio['g1_bucket_reduce']:.2f}x) ({card})")
        results["msm_skew"] = skew
        # the accumulation on one real quotient's members (dense 255-bit scalars)
        q_chunk = chunk_length(1, n_members)
        t_q = time_ms(lambda: kernels.bucket_accumulate(rows, q_order, q_bstart, C_MAIN, q_chunk), reps=10)
        madds, _ = accumulate_point_ops(q_order, q_bstart)
        q_bytes = n_members * 100 + q_bstart.numel() * 4 + g1_ops.chunk_slots(n_members, C_MAIN, q_chunk) * 144
        quotient_acc = {"ms": t_q, **bound(q_bytes, madds * op_imads("madd")), "madds": madds}
        log(f"  g1_bucket_accumulate on a real quotient: {madds} madds, kernel {t_q:.4f} ms, "
            f"bound {quotient_acc['bound_ms']:.5f} ms")
        for kernel in (kernels.bucket_accumulate, kernels.bucket_reduce):
            entries.append({
                "name": kernel.name,
                "route": "cuda",
                "source": f"{PKG}/csrc/msm.cu",
                "replaces": kernel.replaces,
                **counted(kernel.name),
                "max_abs_err": max_err[kernel.name],
                **msm_times[1][kernel.name],
                "library_ms": None,
                "blobs": 1,
                "batch6": msm_times[6][kernel.name],
                **({"quotient": quotient_acc} if kernel is kernels.bucket_accumulate else {}),
            })
        # the generic MSM's combine at phase 3's times; the entry's own
        # numbers are a batch verification's (c = 4, three MSMs a launch)
        main = combine_checked["c4_b3"]
        entries.append({"name": kernels.window_combine.name, "route": "cuda",
                        "source": f"{PKG}/csrc/msm.cu", "replaces": kernels.window_combine.replaces,
                        **counted(kernels.window_combine.name),
                        "max_abs_err": max_err[kernels.window_combine.name],
                        **{key: main[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
                        "library_ms": None, "c": 4, "msms": 3, "shapes": combine_checked})
        shapes = {"madd": 2048, "add": 1024, "dbl": 4096}
        for op, M in shapes.items():
            # random lanes: the rare exceptional lanes would make every
            # warp run the doubling branch too
            p, q, live, q3 = make_lanes(points, M, seed=7 * M, exceptional=False)
            args16 = {"madd": (p, q, live), "add": (p, q3), "dbl": (p,)}[op]
            k_args = [lb.to_u32_layout(a) if a.dtype == torch.int64 else a for a in args16]
            kernel = getattr(kernels, op)
            plain_fn = getattr(g1_ops, op)
            t_plain = [time_ms(lambda: plain_fn(*args16), reps=3, warm=1)]
            t_kernel = [time_ms(lambda: kernel(*k_args), reps=200, warm=5)]
            t_kernel.append(time_ms(lambda: kernel(*k_args), reps=200, warm=5))
            t_plain.append(time_ms(lambda: plain_fn(*args16), reps=3, warm=1))
            nbytes = M * FP_BYTES * {"madd": 3 + 2 + 3, "add": 3 + 3 + 3, "dbl": 3 + 3}[op]
            nbytes += M if op == "madd" else 0
            # random lanes are all live and finite, and none doubles
            imads = op_imads(op) * M
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, imads / IMAD_PER_S * 1e3
            entry = {
                "name": kernel.name,
                "route": "cuda",
                "source": f"{PKG}/csrc/{'g1_batch.cu' if op == 'add' else 'g1.cu'}",
                "replaces": kernel.replaces,
                **counted(kernel.name),
                "max_abs_err": max_err[kernel.name],
                "ms": sum(t_kernel) / 2,
                "plain_ms": sum(t_plain) / 2,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None,
                "lanes": M,
            }
            entries.append(entry)
            log(f"  {kernel.name} M={M}: kernel {entry['ms']:.4f} ms, plain {entry['plain_ms']:.2f} ms, "
                f"bound {entry['bound_ms']:.5f} ms ({entry['bound_by']})")
        # the table build at the mainnet shape; its plain time is phase 3's
        points32 = lb.to_u32_layout(points)
        n = points.shape[-1]
        t_table = [time_ms(lambda: kernels.fixedbase_table(points32, points_valid, C_MAIN),
                           reps=5, warm=1) for _ in range(2)]
        nbytes = n * (2 * FP_BYTES + 1) + num_windows(C_MAIN) * n * 2 * FP_BYTES
        n_valid = int(points_valid.sum())
        imads = table_imads(n_valid, C_MAIN)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, imads / IMAD_PER_S * 1e3
        entry = {
            "name": kernels.fixedbase_table.name,
            "route": "cuda",
            "source": f"{PKG}/csrc/table.cu",
            "replaces": kernels.fixedbase_table.replaces,
            **counted(kernels.fixedbase_table.name),
            "max_abs_err": max_err[kernels.fixedbase_table.name],
            "ms": sum(t_table) / 2,
            "plain_ms": table_plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "lanes": n,
            "c": C_MAIN,
        }
        entries.append(entry)
        log(f"  g1_fixedbase_table N={n} c={C_MAIN} ({n_valid} valid lanes, {imads} IMADs): "
            f"kernel {t_table[0]:.4f} / {t_table[1]:.4f} ms, plain {table_plain_ms:.1f} ms, "
            f"bound {entry['bound_ms']:.5f} ms ({entry['bound_by']})")

        # the batched G1 kernels at the path's shapes: g1_decompress and
        # g1_subgroup_mask on 4096 (a conversion), 128 and 12 lanes (batch
        # verifications of 64 and 6 blobs); g1_scalar_mul in the
        # conversion's split mode on [1/n] (4096 lanes, one scalar) and on
        # an FFT stage's 2048 lanes (the last stage's twiddles: the
        # parent's stage); g1_fft_stage at the inverse FFT's first and last
        # stage; and the two field checks on 4096 elements
        x16 = lb.as_limb_tensor(FP.to_mont_host([pt[0] for pt in setup.g1_monomial]), dev)
        want = torch.rand(n, generator=torch.Generator().manual_seed(9)).to(dev) < 0.5
        aff, valid = g1_ops.make_points_host(setup.g1_monomial)
        jac = g1_ops.lift(lb.as_limb_tensor(aff, dev), torch.from_numpy(valid).to(dev)).contiguous()
        jac32 = lb.to_u32_layout(jac)
        half32 = jac32[:, :, : n // 2].contiguous()
        stages, n_inv = g1_batch._twiddles(n, True)
        k_stage = lb.to_u32_layout(lb.as_limb_tensor(g1_batch._split_limbs(stages[-1]), dev))
        k_inv = lb.to_u32_layout(lb.as_limb_tensor(g1_batch._split_limbs([n_inv]), dev))
        rng_f = random.Random(11)
        f_a, f_b = (lb.to_u32_layout(lb.as_limb_tensor(
            lb.ints_to_limbs([rng_f.randrange(P) for _ in range(n)], 24), dev)) for _ in range(2))
        n_valid = int(valid.sum())

        def timed(fn, reps: int) -> float:
            return sum(time_ms(fn, reps=reps, warm=2) for _ in range(2)) / 2

        def entry_for(kernel, src: str, ms: float, plain_ms: float, nbytes: int, imads: int,
                      lanes: int, **extra) -> dict:
            entry = {"name": kernel.name, "route": "cuda", "source": f"{PKG}/csrc/{src}",
                     "replaces": kernel.replaces, **counted(kernel.name),
                     "max_abs_err": max_err.get(kernel.name, 0), "ms": ms, "plain_ms": plain_ms,
                     **bound(nbytes, imads), "library_ms": None, "lanes": lanes, **extra}
            entries.append(entry)
            log(f"  {kernel.name} M={lanes}: kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, "
                f"bound {entry['bound_ms']:.5f} ms ({entry['bound_by']})")
            return entry

        x32 = lb.to_u32_layout(x16)
        shapes = {}
        for lanes in (n, 128, 12):
            xs32, ws = x32[:, :lanes].contiguous(), want[:lanes].contiguous()
            ms = timed(lambda: kernels.decompress(xs32, ws), 20)
            shapes[f"m{lanes}"] = {"lanes": lanes, "ms": ms,
                                   **bound(lanes * 2 * (FP_BYTES + 1), decompress_imads(lanes))}
            log(f"  g1_decompress M={lanes}: kernel {ms:.4f} ms, bound "
                f"{shapes[f'm{lanes}']['bound_ms']:.5f} ms")
        entry_for(kernels.decompress, "g1_batch.cu", shapes[f"m{n}"]["ms"],
                  time_ms(lambda: g1_ops.decompress_xy(x16, want), reps=1, warm=0),
                  n * 2 * (FP_BYTES + 1), decompress_imads(n), n, shapes=shapes)

        # g1_scalar_mul: each shape's bound from the split schedule's work,
        # and beside it (ladder_bound_ms) the bound of the general
        # double-and-add's work on the same scalars
        shapes = {}
        for shape, pts32, ks, lanes, k32, reps in (
                ("fft_stage", half32, stages[-1], n // 2, k_stage, 20),
                ("inv_n", jac32, [n_inv] * n_valid, n, k_inv, 10)):
            ms = timed(lambda: kernels.scalar_mul(pts32, k32, 128, split=True), reps)
            nbytes = lanes * 2 * 3 * FP_BYTES + k32.numel() * 4
            shapes[shape] = {"lanes": lanes, "ms": ms,
                             **bound(nbytes, sum(split_imads(k) for k in ks)),
                             "ladder_bound_ms": bound(nbytes, sum(ladder_imads(k) for k in ks))["bound_ms"]}
            log(f"  g1_scalar_mul split mode, {shape} M={lanes}: kernel {ms:.4f} ms, bound "
                f"{shapes[shape]['bound_ms']:.5f} ms, double-and-add bound "
                f"{shapes[shape]['ladder_bound_ms']:.5f} ms")
        shapes["fft_stage"]["plain_ms"] = batch_plain_ms["split"]
        shapes["fft_stage"]["plain_general_ms"] = batch_plain_ms["general"]
        inv = shapes["inv_n"]
        entry_for(kernels.scalar_mul, "g1_batch.cu", inv["ms"], batch_plain_ms["split_inv"],
                  n * 2 * 3 * FP_BYTES + k_inv.numel() * 4, split_imads(n_inv) * n_valid, n,
                  mode="split", ladder_bound_ms=inv["ladder_bound_ms"], shapes=shapes)

        # g1_fft_stage on the 4096 monomial points: the inverse FFT's first
        # stage (every twiddle 1) and its last; the bound counts the split
        # schedule's work on each twiddle and two adds per butterfly
        split_stages, _ = g1_batch._split_twiddles(n, True)
        shapes = {}
        for length in (2, n):
            s_idx = length.bit_length() - 2
            k32 = lb.to_u32_layout(lb.as_limb_tensor(split_stages[s_idx], dev))
            ms = timed(lambda: kernels.fft_stage(jac32, length, k32), 20)
            shapes[f"l{length}"] = {"length": length, "ms": ms,
                                    "plain_ms": batch_plain_ms["fft_stage"][length],
                                    **bound(n * 2 * 3 * FP_BYTES + k32.numel() * 4,
                                            fft_stage_imads(stages[s_idx]))}
            log(f"  g1_fft_stage l={length}: kernel {ms:.4f} ms, bound "
                f"{shapes[f'l{length}']['bound_ms']:.5f} ms")
        last = shapes[f"l{n}"]
        entry_for(kernels.fft_stage, "g1_batch.cu", last["ms"], last["plain_ms"],
                  n * 2 * 3 * FP_BYTES + k_stage.numel() * 4, fft_stage_imads(stages[-1]), n // 2,
                  length=n, shapes=shapes)

        # g1_subgroup_mask at a conversion's and two batch verifications' sizes
        shapes = {}
        for lanes in (n, 128, 12):
            pts32 = jac32[:, :, :lanes].contiguous()
            ms = timed(lambda: kernels.subgroup_mask(pts32), 20)
            shapes[f"m{lanes}"] = {"lanes": lanes, "ms": ms,
                                   **bound(lanes * (3 * FP_BYTES + 1),
                                           subgroup_imads(int(valid[:lanes].sum())))}
            log(f"  g1_subgroup_mask M={lanes}: kernel {ms:.4f} ms, bound "
                f"{shapes[f'm{lanes}']['bound_ms']:.5f} ms")
        entry_for(kernels.subgroup_mask, "g1_batch.cu", shapes[f"m{n}"]["ms"],
                  time_ms(lambda: g1_ops.subgroup_mask(jac), reps=1, warm=0),
                  n * (3 * FP_BYTES + 1), subgroup_imads(n_valid), n, shapes=shapes)

        # the field checks: fp::sqr and fp::mul(a, a); the cooperative mul,
        # sqr, add, sub, is_zero and eq beside fp::mul and fp::sqr
        entry_for(kernels.sqr_check, "g1.cu", timed(lambda: kernels.sqr_check(f_a), 20),
                  time_ms(lambda: (FP.sqr(lb.to_u16_layout(f_a)), FP.mul(lb.to_u16_layout(f_a),
                                                                         lb.to_u16_layout(f_a))),
                          reps=1, warm=0),
                  n * 3 * FP_BYTES, n * (IMAD_PER_FP_SQR + IMAD_PER_FP_MUL), n)
        a16, b16 = lb.to_u16_layout(f_a), lb.to_u16_layout(f_b)
        entry_for(kernels.coop_check, "g1_batch.cu", timed(lambda: kernels.coop_check(f_a, f_b), 20),
                  time_ms(lambda: (FP.mul(a16, b16), FP.sqr(a16), FP.add(a16, b16), FP.sub(a16, b16),
                                   FP.is_zero(a16), FP.eq(a16, b16)), reps=1, warm=0),
                  n * 9 * FP_BYTES, n * (3 * IMAD_PER_FP_MUL + IMAD_PER_FP_SQR), n)

        # the pairing kernels at B = 2, every verification's shape (phase 3's
        # true check); their plain times are phase 3's at the same inputs
        ps32, qs32, f32 = pairing_checked["inputs"]
        plain = pairing_checked["b2"]
        # bytes: the Miller loop reads 2 G1 and 2 G2 points and writes 2
        # values of 12 Fp; the final exponentiation reads those and the 6
        # Fp2 constants and writes one value and the verdict
        entry_for(kernels.miller_loop, "pairing.cu",
                  timed(lambda: kernels.miller_loop(ps32, qs32), 20), plain["miller_plain_ms"],
                  2 * (3 + 6 + 12) * FP_BYTES, miller_imads(2), 2)
        entry_for(kernels.final_exp, "pairing.cu", timed(lambda: kernels.final_exp(f32), 20),
                  plain["final_exp_plain_ms"], (2 * 12 + 6 * 2 + 12) * FP_BYTES + 1,
                  final_exp_imads(2), 2)

        # the Fr kernels at the blob domain, timed in phase 3 on 1, 6 and 64
        # blobs (the entry's own numbers are B = 1's, a single proof's), and
        # fr_check on 4096 elements
        for name in FR_KERNELS + ("fr_check",):
            shapes = fr_checked[name]
            first = shapes["m4096" if name == "fr_check" else "b1"]
            entries.append({"name": name, "route": "cuda", "source": f"{PKG}/csrc/fr_poly.cu",
                            "replaces": getattr(kernels, name).replaces, **counted(name),
                            "max_abs_err": max_err[name],
                            **{key: first[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
                            "library_ms": None, "n": NTT_N, "shapes": shapes})

        # g1_fold at phase 3's times; the entry's own numbers are the (1, 4)
        # mesh's fold of a batch of 6 (K = 4 rows of 6 lanes)
        main = fold_checked["k4_b6"]
        entries.append({"name": kernels.fold.name, "route": "cuda", "source": f"{PKG}/csrc/g1_batch.cu",
                        "replaces": kernels.fold.replaces, **counted(kernels.fold.name),
                        "max_abs_err": max_err[kernels.fold.name],
                        **{key: main[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
                        "library_ms": None, "rows": 4, "lanes": 6, "shapes": fold_checked})

        # the roofline table of utils/profiling.py: g1_madd, g1_add and
        # g1_dbl chained in one CUDA graph at 8192 lanes, and the plain Fp
        # product, against the card's speed of light
        stats = collect_kernel_stats()
        results["roofline"] = [{"name": st.name, "lanes": st.lanes, "ns_per_lane": st.ns_per_lane,
                                "fp_mul_rate": st.fp_mul_rate} for st in stats]
        for line in roofline_table(stats).splitlines():
            log("  " + line)

    kernels.reset_counts()  # the mesh path starts here
    with Phase("11 the mesh"):
        results["mesh"] = check_mesh(converted, dev, commit_set, prove_set, batches)
        mesh_launches = launch_counts()  # the path ends here
        log(f"  mesh path launches {mesh_launches}")
        missing = [name for name in MESH_KERNELS if mesh_launches[name] == 0]
        if missing:
            raise AssertionError(f"not launched on the mesh path: {missing}")
        for entry in entries:
            n = mesh_launches.get(entry["name"], 0)
            entry["launches_by_path"]["mesh"] = n
            entry["launches"] += n
        log(f"  {card}; the meshes are logical: one card runs every shard, so no time here is a "
            "multi-card time")

    with Phase("12 the C ABI"):
        results["capi"], capi_launches = capi_phase(ctx, card)
        for entry in entries:
            n = capi_launches.get(entry["name"], 0)
            entry["launches_by_path"]["capi"] = n
            entry["launches"] += n

    with Phase("13 the native tier"):
        results["native"] = native_phase(ctx, *batches[6], card)
        results["native"]["build_s"] = results["native_build_s"]

    with Phase("14 distributed"):
        results["distributed"], dist_launches = distributed_phase(commit_set, batches[6], ntt_set, card)
        for entry in entries:
            n = dist_launches.get(entry["name"], 0)
            entry["launches_by_path"]["distributed"] = n
            entry["launches"] += n

    with Phase("15 generic MSM at 2^16 and 2^20"):
        results["generic_msm"], generic_launches = generic_msm_phase(setup, dev, card)
        for entry in entries:
            n = generic_launches.get(entry["name"], 0)
            entry["launches_by_path"]["generic_msm"] = n
            entry["launches"] += n

    with Phase("16 fuzz"):
        results["fuzz"], fuzz_launches = fuzz_phase(card)
        for entry in entries:
            n = fuzz_launches.get(entry["name"], 0)
            entry["launches_by_path"]["fuzz"] = n
            entry["launches"] += n

    with Phase("17 bench"):
        results["bench"], bench_launches = bench_phase(device, card)
        for entry in entries:
            n = bench_launches.get(entry["name"], 0)
            entry["launches_by_path"]["bench"] = n
            entry["launches"] += n

    log(json.dumps({"end_to_end": results, "card": card}))
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": device}))


def main() -> int:
    if sys.argv[1:2] == ["--rank"]:  # one rank of phase 14
        coord, world, rank, job_path = sys.argv[2:6]
        return rank_worker(coord, int(world), int(rank), job_path)
    try:
        run()
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 2
    except Exception:  # any failed phase: report it and exit non-zero
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
