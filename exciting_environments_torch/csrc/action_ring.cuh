// The action ring: a block of one-thread-per-instance kernels stages its
// instances' action slab through shared-memory tiles filled with cp.async
// ahead of the rows being integrated, from either slab layout in place.
// Shared by the open-loop stepper (stepper.cu) and the fast pendulum
// (pendulum_fast.cu).
//
// A tile holds K action rows (TILE_BYTES of one instance's actions) of the
// block's NT instances.  A tile is a set of lines: time-major (n_rows, B,
// A), K rows of NT * A contiguous values; batch-major (B, n_rows, A), NT
// instance rows of K * A.  A line is copied in pieces of E elements (16
// bytes where every line starts on a 16-byte boundary, else one action
// vector of A elements), piece p of the block's tile by thread p % NT; the
// ragged edges (past the batch or the horizon) are zero-filled.  A slot
// holds a time-major tile as [row][instance][a] and a batch-major one as
// [instance][row * A + a], rows of KA + PAD elements, so that each thread
// reads its own column.
#pragma once

#include <cuda_runtime.h>

// The ring's geometry for NT threads, actions of A values of type T, and
// TB bytes of one instance's actions per tile.
template <typename T, int A, int NT, int TB>
struct Ring {
    static constexpr int THREADS = NT;
    static constexpr int K = TB / (A * (int)sizeof(T));  // action rows per tile
    static constexpr int KA = K * A;
    static constexpr int PAD = 16 / (int)sizeof(T);  // a batch-major row's padding, one 16-byte piece
    static constexpr int SLOT = NT * (KA + PAD);     // elements of one tile
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

// This thread's share of every tile copy: it copies the pieces at one
// position `pos` of every `lines_per_pass`-th line, from line `line0` on.
struct TileCopy {
    long long src;       // element offset of the thread's first piece in tile 0
    long long src_line;  // element step from one of its pieces to the next
    long long src_tile;  // element step from one tile to the next
    int dst, dst_line;   // the same in a slot
    int line0, lines_per_pass, n;  // first line, line step, pieces per tile
    int pos_elem;        // the piece's first element within its line
};

template <class R>
__device__ __forceinline__ TileCopy tile_copy(int e, long long b0, long long batch, int n_rows, bool batch_major) {
    constexpr int A = R::N_ACTION;
    constexpr int NT = R::THREADS;
    TileCopy c;
    const int line_elems = batch_major ? R::KA : NT * A;
    const int pieces = line_elems / e;  // per line; divides NT
    c.lines_per_pass = NT / pieces;
    c.line0 = threadIdx.x / pieces;
    c.pos_elem = (threadIdx.x % pieces) * e;
    c.n = (batch_major ? NT : R::K) / c.lines_per_pass;
    if (batch_major) {
        c.src_line = (long long)n_rows * A * c.lines_per_pass;
        c.src = (b0 + c.line0) * n_rows * A + c.pos_elem;
        c.src_tile = R::KA;
        c.dst_line = (R::KA + R::PAD) * c.lines_per_pass;
        c.dst = c.line0 * (R::KA + R::PAD) + c.pos_elem;
    } else {
        c.src_line = batch * A * c.lines_per_pass;
        c.src = c.line0 * batch * A + b0 * A + c.pos_elem;
        c.src_tile = (long long)R::K * batch * A;
        c.dst_line = NT * A * c.lines_per_pass;
        c.dst = c.line0 * NT * A + c.pos_elem;
    }
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
    const bool pos_ok = batch_major ? row0 * A + c.pos_elem < n_rows * A : b0 * A + c.pos_elem < batch * A;
    const T* src = slab + c.src + tile * c.src_tile;
    T* dst = slot + c.dst;
    int line = c.line0;
#pragma unroll 1
    for (int m = 0; m < c.n; ++m) {
        const bool ok = pos_ok && line < lines;
        cp_async<U>(dst, ok ? src : slab, ok);
        src += c.src_line;
        dst += c.dst_line;
        line += c.lines_per_pass;
    }
}

// Whether every line of a slab starts on a 16-byte boundary, so that a tile
// is copied in 16-byte pieces: the slab's base and its line length (B * A
// elements time-major, n_rows * A batch-major) are 16-byte multiples.
template <typename T>
__device__ __forceinline__ bool ring_vec16(const T* slab, long long line_elems) {
    return (reinterpret_cast<size_t>(slab) % 16 == 0) && (line_elems * (long long)sizeof(T)) % 16 == 0;
}
