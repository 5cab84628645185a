// The action ring: a block of one-thread-per-instance kernels stages its
// instances' action slab through shared-memory tiles filled with cp.async
// ahead of the rows being integrated, from either slab layout in place.
// Shared by the open-loop stepper (stepper.cu) and the fast pendulum
// (pendulum_fast.cu).
//
// A tile holds K action rows (at most TILE_BYTES of one instance's actions)
// of the block's NT instances.  A tile is a set of lines: time-major
// (n_rows, B, A), K rows of NT * A contiguous values; batch-major (B,
// n_rows, A), NT instance rows of K * A.  A line is copied in pieces of E
// elements: 16 bytes where every line starts on a 16-byte boundary, else one
// action vector of A elements where that is a cp.async size (4, 8 or 16
// bytes), else one element.  The block's threads take the tile's pieces in
// turn, piece p by thread p % NT; the ragged edges (past the batch or the
// horizon) are zero-filled.  A slot holds a time-major tile as
// [row][instance][a] and a batch-major one as [instance][row * A + a], rows
// of KA + PAD elements, so that each thread reads its own column.
#pragma once

#include <cuda_runtime.h>

__host__ __device__ constexpr int ring_gcd(int a, int b) { return b == 0 ? a : ring_gcd(b, a % b); }

// The ring's geometry for NT threads, actions of A values of type T, and at
// most TB bytes of one instance's actions per tile.  K is rounded down so
// that a batch-major line (K * A values) is a whole number of 16-byte
// pieces; PAD is one 16-byte piece, or two where one would put the rows of
// neighbouring instances 32 words apart (on the same bank).
template <typename T, int A, int NT, int TB>
struct Ring {
    static constexpr int THREADS = NT;
    static constexpr int ROW_BYTES = A * (int)sizeof(T);
    static constexpr int UNIT = 16 / ring_gcd(16, ROW_BYTES);      // rows per whole 16-byte line
    static constexpr int K = TB / ROW_BYTES / UNIT * UNIT;          // action rows per tile
    static constexpr int KA = K * A;
    static constexpr int P16 = 16 / (int)sizeof(T);
    static constexpr int PAD = ((KA + P16) * (int)sizeof(T) / 4) % 8 == 0 ? 2 * P16 : P16;
    static constexpr int SLOT = NT * (KA + PAD);                    // elements of one tile
    // elements of an element-wise piece: the action vector where cp.async
    // copies its size, else one value
    static constexpr int E1 = (ROW_BYTES == 4 || ROW_BYTES == 8 || ROW_BYTES == 16) ? A : 1;
    static_assert(K >= 1, "a tile holds at least one action row");
    using Type = T;
    static constexpr int N_ACTION = A;
};

// One cp.async of N bytes; src_bytes 0 zero-fills the destination.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    const int src_bytes = valid ? N : 0;
    if constexpr (N == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src), "n"(N), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// This thread's share of every tile copy: pieces threadIdx.x,
// threadIdx.x + NT, ... of the tile's lines * ppl pieces, walked as (line,
// position) without a division.  Where the action vector is a cp.async size
// (Ring::E1 == A), a line's pieces divide the block's threads, so a thread's
// pieces sit at one position of every dl-th line and its walk is a pointer
// step (first, step).
struct TileCopy {
    long long src;       // element offset of the block's tile 0, line 0
    long long src_line;  // element step from one line to the next
    long long src_tile;  // element step from one tile to the next
    int dst_line;        // the same in a slot
    int lines, ppl, e;   // lines per tile, pieces per line, elements per piece
    int line0, pos0;     // the thread's first piece
    int dl, dp;          // the step of NT pieces, in lines and positions
    int n;               // pieces per thread and tile (the last may lie past the tile)
    long long first, step;  // the thread's first piece and its step, in the slab (E1 == A)
    int dst_first, dst_step;  // the same in a slot
};

template <class R>
__device__ __forceinline__ TileCopy tile_copy(int e, long long b0, long long batch, int n_rows, bool batch_major) {
    constexpr int A = R::N_ACTION;
    constexpr int NT = R::THREADS;
    TileCopy c;
    c.e = e;
    c.lines = batch_major ? NT : R::K;
    c.ppl = (batch_major ? R::KA : NT * A) / e;
    c.line0 = threadIdx.x / c.ppl;
    c.pos0 = threadIdx.x % c.ppl;
    c.dl = NT / c.ppl;
    c.dp = NT % c.ppl;
    c.n = (c.lines * c.ppl + NT - 1) / NT;
    if (batch_major) {
        c.src = b0 * n_rows * A;
        c.src_line = (long long)n_rows * A;
        c.src_tile = R::KA;
        c.dst_line = R::KA + R::PAD;
    } else {
        c.src = b0 * A;
        c.src_line = batch * A;
        c.src_tile = (long long)R::K * batch * A;
        c.dst_line = NT * A;
    }
    c.first = c.src + c.line0 * c.src_line + c.pos0 * e;
    c.step = c.dl * c.src_line;
    c.dst_first = c.line0 * c.dst_line + c.pos0 * e;
    c.dst_step = c.dl * c.dst_line;
    return c;
}

// Issue tile `tile` (action rows tile*K ... tile*K + K - 1 of the block's
// instances) into `slot` in pieces of U bytes; pieces past the batch or the
// horizon are zero-filled.
template <class R, int U>
__device__ __forceinline__ void issue_tile(typename R::Type* slot, const typename R::Type* __restrict__ slab,
                                           const TileCopy& c, int tile, long long b0, long long batch, int n_rows,
                                           bool batch_major) {
    using T = typename R::Type;
    constexpr int A = R::N_ACTION;
    const int row0 = tile * R::K;
    // a piece is valid while its line is (rows of the horizon, instances of
    // the batch) and its position is (instances, row elements)
    const long long lines = batch_major ? batch - b0 : (long long)(n_rows - row0);
    const long long line_elems = batch_major ? (long long)(n_rows - row0) * A : (batch - b0) * A;
    if constexpr (R::E1 == A) {
        const bool pos_ok = c.pos0 * c.e < line_elems;
        const T* src = slab + c.first + tile * c.src_tile;
        T* dst = slot + c.dst_first;
        int line = c.line0;
#pragma unroll 1
        for (int m = 0; m < c.n; ++m) {
            const bool ok = pos_ok && line < lines;
            cp_async<U>(dst, ok ? src : slab, ok);
            src += c.step;
            dst += c.dst_step;
            line += c.dl;
        }
    } else {
        const T* src = slab + c.src + tile * c.src_tile;
        int line = c.line0, pos = c.pos0;
#pragma unroll 1
        for (int m = 0; m < c.n; ++m) {
            if (line < c.lines) {
                const int el = pos * c.e;
                const bool ok = line < lines && el < line_elems;
                cp_async<U>(slot + line * c.dst_line + el, ok ? src + line * c.src_line + el : slab, ok);
            }
            line += c.dl;
            pos += c.dp;
            if (pos >= c.ppl) {
                pos -= c.ppl;
                ++line;
            }
        }
    }
}

// Whether every line of a slab starts on a 16-byte boundary, so that a tile
// is copied in 16-byte pieces: the slab's base and its line length (B * A
// elements time-major, n_rows * A batch-major) are 16-byte multiples.
template <typename T>
__device__ __forceinline__ bool ring_vec16(const T* slab, long long line_elems) {
    return (reinterpret_cast<size_t>(slab) % 16 == 0) && (line_elems * (long long)sizeof(T)) % 16 == 0;
}
