// Native host planner: the serial entropy hot loop in C++ (SURVEY.md §7 M4).
//
// Python's per-block planner costs ~0.45 s per 640×480 frame — far below the
// device core's throughput, so the production pipeline uses this translation
// unit via ctypes (`hvqm4_tpu/native/__init__.py`). It implements exactly the
// same frame→plan resolution as `hvqm4_tpu/planner.py` (docs/FORMAT.md §3–§7)
// and is differential-tested against it (tests/test_native.py).
//
// Performance notes:
// - 64-bit windowed bit reader (refills 8 bytes at a time, branch-light).
// - Single-level 12-bit Huffman LUT with tree-walk fallback for longer codes;
//   the LUT is built once per (stream, frame) during tree parsing.
// - Outputs are written in the *packed device layout* (2 B/block dense +
//   per-MB motion vectors + sparse payload pools): basis descriptors stay in
//   their 32-bit wire format (FORMAT.md §6.5), cls/refsel/mode pack into one
//   meta byte, and pool slots are allocated in canonical block scan order
//   (plane-major) so the device recomputes every raw/desc index from meta
//   alone (exclusive cumsum) — the slot arrays written here are host-side
//   scratch, never uploaded. Host→device transfer shrinks ~4x vs a dense
//   per-block layout.
// - Every field the device reads unmasked is written on every call, so output
//   buffers may be reused across frames without clearing.
//
// Thread-safety: no global mutable state (scratch lives in the per-call
// stack / caller buffers), so Python can fan out streams across threads with
// the GIL released (ctypes releases it around foreign calls).
//
// Error handling: exceptions caught at the boundary; returns 0 on success or
// writes a message into err_buf and returns nonzero (the per-stream
// poisoning contract of SURVEY.md §5).

#include <array>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <memory>
#include <mutex>
#include <thread>
#include <cstring>
#include <stdexcept>
#include <vector>

namespace {

// set inside hvqm4_plan_step worker threads so per-frame slice threading
// doesn't nest (thread explosion) when the step itself is threaded
thread_local bool g_in_step_worker = false;

struct Error : std::runtime_error {
    using std::runtime_error::runtime_error;
};

// ---------------- 64-bit windowed bit reader (MSB-first) ----------------

struct BitReader {
    const uint8_t* d = nullptr;
    size_t nbytes = 0;
    size_t byte_pos = 0;   // next byte to load into the window
    uint64_t window = 0;   // MSB-aligned pending bits
    int have = 0;          // valid bits in window (from MSB side)

    void init(const uint8_t* data, size_t n) {
        d = data;
        nbytes = n;
        byte_pos = 0;
        window = 0;
        have = 0;
    }

    inline void refill() {
        if (have > 56) return;
        if (byte_pos + 8 <= nbytes) {
            // bulk path: one unaligned 64-bit load, big-endian normalized;
            // keep only the whole bytes that fit, or later refills would OR
            // fresh bits over stale tail garbage
            uint64_t chunk;
            std::memcpy(&chunk, d + byte_pos, 8);
            chunk = __builtin_bswap64(chunk);
            int nbits_take = (64 - have) & ~7;
            chunk &= ~0ULL << (64 - nbits_take);
            window |= chunk >> have;
            byte_pos += (size_t)(nbits_take >> 3);
            have += nbits_take;
            return;
        }
        while (have <= 56 && byte_pos < nbytes) {
            window |= (uint64_t)d[byte_pos++] << (56 - have);
            have += 8;
        }
    }

    // peek up to 32 bits (zero-padded past end; overconsumption is caught
    // in take()/bits())
    inline uint32_t peek(int n) {
        if (have < n) refill();
        return (uint32_t)(window >> (64 - n));
    }

    inline void take(int n) {
        if (n > have) throw Error("bit stream exhausted");
        window <<= n;
        have -= n;
    }

    inline uint32_t bits(int n) {
        if (have < n) {
            refill();
            if (have < n) throw Error("bit stream exhausted");
        }
        uint32_t v = (uint32_t)(window >> (64 - n));
        window <<= n;
        have -= n;
        return v;
    }

    inline unsigned bit() { return bits(1); }

    inline int32_t sbits(int n) {
        uint32_t v = bits(n);
        if (v >= (1u << (n - 1))) return (int32_t)v - (int32_t)(1u << n);
        return (int32_t)v;
    }
};

// The aux (raw/descriptor payload) stream is consumed exclusively in whole
// 32-bit units (FORMAT.md §5: raw blocks 4 words, descriptors 1 word each),
// so it never needs the shifting bit window: a bare byte cursor with
// direct big-endian loads decodes it ~3x cheaper per word.
struct WordReader {
    const uint8_t* d = nullptr;
    size_t nbytes = 0, pos = 0;

    void init(const uint8_t* data, size_t n) {
        d = data;
        nbytes = n;
        pos = 0;
    }

    inline const uint8_t* take_bytes(size_t n) {
        if (pos + n > nbytes) throw Error("bit stream exhausted");
        const uint8_t* p = d + pos;
        pos += n;
        return p;
    }

    inline uint32_t word() {  // big-endian u32
        uint32_t v;
        std::memcpy(&v, take_bytes(4), 4);
        return __builtin_bswap32(v);
    }
};

// ---------------- Huffman with 12-bit decode LUT ----------------

constexpr int LUT_BITS = 12;

struct Huff {
    std::vector<std::array<int, 2>> nodes;  // leaves: -(sym+1)
    // lut[i]: (len << 16) | sym for codes of length <= LUT_BITS;
    // (0x8000'0000 | node) for longer codes (continue walking at `node`
    // after consuming LUT_BITS bits); 0 = invalid (unreachable in a valid
    // serialized tree).
    std::vector<uint32_t> lut;
    int root = 0;
    bool present = false;
    BitReader br;

    int read_tree(int depth, uint32_t code, int len) {
        if (depth > 64) throw Error("huffman tree too deep");
        if (br.bit()) {
            // normative cap: > 1024 INTERNAL nodes is invalid (FORMAT.md 4.2)
            if (nodes.size() >= 1024) throw Error("huffman tree too large");
            int idx = (int)nodes.size();
            nodes.push_back({0, 0});
            int c0 = read_tree(depth + 1, code << 1, len + 1);
            int c1 = read_tree(depth + 1, (code << 1) | 1, len + 1);
            nodes[idx] = {c0, c1};
            if (len == LUT_BITS) {  // deep subtree: continuation entry
                lut[code] = 0x80000000u | (uint32_t)idx;
            }
            return idx;
        }
        int sym = (int)br.bits(8);
        if (len <= LUT_BITS) {
            // fill all LUT slots prefixed by this code
            uint32_t base = code << (LUT_BITS - len);
            uint32_t cnt = 1u << (LUT_BITS - len);
            uint32_t entry = ((uint32_t)len << 16) | (uint32_t)sym;
            for (uint32_t i = 0; i < cnt; i++) lut[base + i] = entry;
        }
        return -(sym + 1);
    }

    void init(const uint8_t* d, size_t n) {
        nodes.clear();
        nodes.reserve(640);
        present = n > 0;
        br.init(d, n);
        if (!present) return;
        // No zero-fill: a serialized tree is complete by construction (every
        // internal node has both children), so its leaves + continuation
        // entries cover the entire LUT index space.
        lut.resize(1u << LUT_BITS);
        root = read_tree(0, 0, 0);
        if (root < 0) {  // degenerate single-leaf tree: 0-bit symbols
            uint32_t entry = (uint32_t)(-root - 1);  // len 0
            lut.assign(1u << LUT_BITS, entry);
        }
    }

    inline int symbol() {
        if (!present) throw Error("symbol from empty huffman stream");
        uint32_t p = br.peek(LUT_BITS);
        uint32_t e = lut[p];
        if (!(e & 0x80000000u)) {
            br.take((int)(e >> 16));
            return (int)(e & 0xFFFF);
        }
        br.take(LUT_BITS);
        int node = (int)(e & 0x7FFFFFFFu);
        while (node >= 0) node = nodes[node][br.bit()];
        return -node - 1;
    }

    inline int32_t delta() {
        int s = symbol();
        if (s == 255) return br.sbits(16);
        return s - 127;
    }

};

// ---------------- packed output plan layout ----------------
// meta byte: mode(0..6) in bits 0-2, refsel in bits 3-4, cls in bit 5.
//
// A block is either raw (cls 0, mode 6 — needs a raw-pool slot) or carries
// basis descriptors (needs a desc-pool start) — never both, so ONE u32
// `slot` field serves both roles; the device disambiguates by meta and
// masks the other gather. Motion vectors are per-MACROBLOCK quantities
// (every block of an MB shares the MB's vector), so they are emitted once
// per MB at luma resolution into FrameOut.mv/mv2 and the device expands
// them per plane (repeat 2x2 for 2-blocks-per-MB planes, arithmetic >>1
// for 4:2:0 chroma). Together these cut the dense per-step upload ~2.5x.

struct PlaneOut {
    uint8_t* meta;        // bh*bw
    uint8_t* dc;          // bh*bw
    uint32_t* slot;       // bh*bw   raw-pool slot (mode 6) or desc-pool start
    uint32_t* meta5;      // ceil(bh*bw/5): meta is 6 bits, 5 blocks per u32
                          // (the upload form; packed here so the Python
                          // assembly step is a row memcpy, not bit math)
};

// Shared per-stream pools (sparse payloads). Strided so the multi-stream
// batch can lay pools out stream-minor ((slot, stream, ...)) and upload only
// the used prefix. Strides are in ELEMENTS of the pool's dtype.
struct PoolOut {
    uint8_t* raw_pool;     // slot i, byte j at raw_pool[i*raw_stride + j]
    size_t raw_stride;     // >= 16
    size_t raw_cap;        // slots available
    uint32_t* desc_pool;   // slot i at desc_pool[i*desc_stride]
    size_t desc_stride;    // >= 1
    size_t desc_cap;
    // sparse DC pool: one byte per DC-carrying block (intra, mode != 6) in
    // canonical block-scan order. The dense dc grid is ~92% inter filler
    // (128) on typical content; uploading only the carried DCs cuts the
    // per-frame transfer ~26 KB at 640x480. The device re-derives each
    // block's pool slot from meta (exclusive cumsum), like raw/desc.
    uint8_t* dc_pool;      // slot i at dc_pool[i*dc_stride]
    size_t dc_stride;      // >= 1
    size_t dc_cap;
};

struct FrameOut {
    uint32_t display_id;
    uint32_t dc_shift;
    uint32_t nest_x, nest_y;
    uint32_t raw_used, desc_used;  // pool slots consumed by this frame
    uint32_t dc_used;              // DC pool bytes consumed
    uint32_t mv_flags;             // bit0 any nonzero FIRST vector, bit1
                                   // every first-vector component fits s8,
                                   // bit2 any second (refsel-2) vector —
                                   // the host picks the step's mv variant
                                   // from these without re-scanning the
                                   // grids (v6: the flags cover mv only;
                                   // mv2 rides a meta-derived pool)
    uint32_t mv2_carriers;         // bi MBs (luma top-left block cls==1 &
                                   // refsel==2): the slot's mv2 pool length
    uint32_t pad_;
    uint64_t meta_mask;            // OR of (1 << meta byte) over all blocks
                                   // of all planes — the host derives the
                                   // step's meta codebook width from it
    uint8_t* nest;  // nest_h*nest_w (filled for I frames)
    uint32_t* mv;   // (mh, mw) per-MB forward vector, packed (y16 << 16 | x16),
                    // luma half-pel units (P/B; 0 on I)
    uint32_t* mv2;  // (mh, mw) per-MB backward vector (refsel-2 B blocks)
};

// Per-MB state consumed by plane(): 1 byte (type bits 0-1, refsel 2-3).
// The vectors go straight to FrameOut.mv/mv2 as packed u32 — keeping this
// to a byte cuts mb_rows' store traffic ~20x (measured 28% of retail-
// content planning before).
typedef uint8_t MBInfo;
inline unsigned mb_type(MBInfo m) { return m & 3; }
inline unsigned mb_refsel(MBInfo m) { return (m >> 2) & 3; }

constexpr int MB_COPY = 0, MB_INTRA = 1, MB_INTER = 2;

struct Geometry {
    int width, height, h_samp, v_samp;
    int pw[3], ph[3], bw[3], bh[3], mh, mw, nest_h, nest_w;
};

// One slice's decode context (the whole frame is one slice when unsliced);
// writes disjoint block rows of the shared outputs, so slices can run on
// separate threads (FORMAT.md Â§9).
struct SliceDec {
    const Geometry* g;
    const PoolOut* pools;
    std::atomic<uint32_t>* raw_ctr;   // shared across slices of the frame
    std::atomic<uint32_t>* desc_ctr;
    std::atomic<uint32_t>* dc_ctr;
    int ftype;  // 0=I 1=P 2=B
    int ms0, ms1;  // MB-row range [ms0, ms1)
    Huff bn, dch, mvh;
    WordReader aux;
    BitReader mbt;
    int bn_zero_run = 0;
    MBInfo* mbs;  // shared, row-disjoint

    inline void write_raw(PlaneOut& p, size_t bi) {
        uint32_t slot = raw_ctr->fetch_add(1, std::memory_order_relaxed);
        if (slot >= pools->raw_cap) throw Error("raw pool overflow");
        p.slot[bi] = slot;
        // the 16 raw pixels are the stream bytes verbatim (4 BE words)
        std::memcpy(pools->raw_pool + (size_t)slot * pools->raw_stride,
                    aux.take_bytes(16), 16);
    }

    inline void write_descs(PlaneOut& p, size_t bi, int k) {
        uint32_t slot = desc_ctr->fetch_add((uint32_t)k,
                                            std::memory_order_relaxed);
        if (slot + k > pools->desc_cap) throw Error("desc pool overflow");
        p.slot[bi] = slot;
        for (int i = 0; i < k; i++)
            pools->desc_pool[(size_t)(slot + i) * pools->desc_stride] =
                aux.word();
    }

    inline int basisnum() {
        if (bn_zero_run) {
            bn_zero_run--;
            return 0;
        }
        int s = bn.symbol();
        if (s == 7) {
            bn_zero_run = (int)bn.br.bits(8);
            return 0;
        }
        if (s > 7) throw Error("basisnum symbol out of range");
        return s;
    }

    // Decodes MB types + MV chains, emitting per-MB vectors straight into
    // the FrameOut mv/mv2 arrays (row range [ms0, ms1) — slice-disjoint).
    void mb_rows(uint32_t* mv, uint32_t* mv2) {
        int32_t px = 0, py = 0;  // MV chain resets per slice
        for (int my = ms0; my < ms1; my++) {
            for (int mx = 0; mx < g->mw; mx++) {
                unsigned t = mbt.bits(2);
                if (t == 3) throw Error("mbtype 3 invalid");
                unsigned refsel = 0;
                int32_t mvx = 0, mvy = 0, mv2x = 0, mv2y = 0;
                if (t == MB_COPY) {
                    refsel = (ftype == 1) ? 1 : 0;
                } else if (t == MB_INTER) {
                    if (ftype == 2) {
                        refsel = mbt.bits(2);
                        if (refsel == 3) throw Error("refsel 3 invalid");
                    } else {
                        refsel = 1;
                    }
                    // the chain wraps to signed 16-bit after every delta
                    // (FORMAT.md 7.2): defined for hostile long chains
                    px = (int16_t)(px + mvh.delta());
                    py = (int16_t)(py + mvh.delta());
                    mvx = px;
                    mvy = py;
                    if (refsel == 2) {
                        px = (int16_t)(px + mvh.delta());
                        py = (int16_t)(py + mvh.delta());
                        mv2x = px;
                        mv2y = py;
                    }
                }
                const size_t mi = (size_t)my * g->mw + mx;
                mbs[mi] = (MBInfo)(t | (refsel << 2));
                // one packed u32 per MB keeps vectors in the u32 upload
                // arena (no separate i16 transfer) and the TPU side
                // unpacks with two shifts
                mv[mi] = ((uint32_t)(uint16_t)mvy << 16) | (uint16_t)mvx;
                mv2[mi] = ((uint32_t)(uint16_t)mv2y << 16) | (uint16_t)mv2x;
            }
        }
    }

    // One intra block: mode, DC chain, raw/descriptor payloads. Shared by
    // the I-frame fast loop and the P/B general loop.
    //
    // NOTE a batched alternative (decode each entropy stream in multi-
    // symbol runs, then a symbol-free block pass) was built and measured
    // in round 3: it lost 18-27% on BOTH heavy and retail-bitrate content
    // — the extra block-grid scans and scratch-array traffic cost more
    // than multi-symbol chaining saves at these code lengths. Single-pass
    // with the 12-bit LUT is the faster structure on this codec.
    inline void intra_block(PlaneOut& p, uint8_t* dcg, size_t bi,
                            int bx, int by, int row0, int W,
                            int dc_shift) {
        int mode = basisnum();
        if (mode == 5) throw Error("intra basisnum 5 invalid");
        p.meta[bi] = (uint8_t)mode;  // cls=0 refsel=0
        if (mode == 6) {
            write_raw(p, bi);
            p.dc[bi] = dcg[bi] = 128;
        } else {
            int pred = bx > 0        ? dcg[bi - 1]
                       : by > row0   ? dcg[bi - W]
                                     : 128;
            int32_t v = dch.delta();
            const uint8_t dc = (uint8_t)(
                (uint32_t)(pred + v * (1 << dc_shift)) & 0xFF);
            p.dc[bi] = dcg[bi] = dc;
            uint32_t ds = dc_ctr->fetch_add(1, std::memory_order_relaxed);
            if (ds >= pools->dc_cap) throw Error("dc pool overflow");
            pools->dc_pool[(size_t)ds * pools->dc_stride] = dc;
            if (mode) write_descs(p, bi, mode);
        }
    }

    void plane(int pi, int dc_shift, PlaneOut& p) {
        const int W = g->bw[pi];
        const bool chroma_mb = (pi > 0 && g->h_samp == 2);
        const int shift_idx = chroma_mb ? 0 : 1;
        const int rpm = chroma_mb ? 1 : 2;  // block rows per MB row
        const int row0 = ms0 * rpm, row1 = ms1 * rpm;
        uint8_t* dcg = p.dc;
        if (ftype == 0) {     // I-frame fast path: every block is intra
            for (int by = row0; by < row1; by++) {
                size_t bi = (size_t)by * W;
                for (int bx = 0; bx < W; bx++, bi++)
                    intra_block(p, dcg, bi, bx, by, row0, W, dc_shift);
            }
            return;
        }
        for (int by = row0; by < row1; by++) {
            const MBInfo* mbrow = &mbs[(size_t)(by >> shift_idx) * g->mw];
            for (int bx = 0; bx < W; bx++) {
                const size_t bi = (size_t)by * W + bx;
                const MBInfo mb = mbrow[bx >> shift_idx];
                if (mb_type(mb) == MB_INTRA) {
                    intra_block(p, dcg, bi, bx, by, row0, W, dc_shift);
                } else {
                    p.dc[bi] = dcg[bi] = 128;
                    if (mb_type(mb) == MB_INTER) {
                        int k = basisnum();
                        if (k > 4) throw Error("inter residual count invalid");
                        p.meta[bi] = (uint8_t)(0x20 | (mb_refsel(mb) << 3)
                                               | k);
                        if (k) write_descs(p, bi, k);
                    } else {
                        p.meta[bi] = (uint8_t)(0x20 | (mb_refsel(mb) << 3));
                    }
                }
            }
        }
    }

};

// Per-call scratch (slice contexts with their Huffman tables, the MB grid,
// compaction buffers), recycled through a mutex-guarded freelist so repeat
// calls skip ~50-200 KB of allocations per frame. A freelist — NOT
// thread_local — because hvqm4_plan_step spawns FRESH worker threads per
// call when HVQM4_PLANNER_THREADS > 1, and heap hung off a thread_local
// raw pointer would leak once per thread per call (advisor round-3
// finding). The pool itself is intentionally never destroyed (a static
// with a destructor in a dlopen'd library segfaults at interpreter
// teardown); its size is bounded by the peak thread count.
struct Scratch {
    std::vector<SliceDec> slices;
    std::vector<MBInfo> mbs;
    std::vector<uint8_t> raw_scratch;
    std::vector<uint32_t> desc_scratch;
};

std::mutex* g_scratch_mu = new std::mutex();
std::vector<Scratch*>* g_scratch_pool = new std::vector<Scratch*>();

struct ScratchLease {
    Scratch* s;
    ScratchLease() {
        std::lock_guard<std::mutex> lk(*g_scratch_mu);
        if (g_scratch_pool->empty()) {
            s = new Scratch();
        } else {
            s = g_scratch_pool->back();
            g_scratch_pool->pop_back();
        }
    }
    ~ScratchLease() {
        std::lock_guard<std::mutex> lk(*g_scratch_mu);
        g_scratch_pool->push_back(s);
    }
};

// Renumber pool slots into canonical order (plane-major, row-major block
// scan) after threaded slice decode, rewriting the slot fields and moving
// the pool payloads. Single-threaded decode allocates canonically by
// construction; this pass makes the threaded path indistinguishable, so
// the device can always derive slot indices from meta alone.
void compact_pools(const Geometry& g, PlaneOut* planes, const PoolOut* pools,
                   uint32_t raw_used, uint32_t desc_used, Scratch& scr) {
    std::vector<uint8_t>& raw_scratch = scr.raw_scratch;
    std::vector<uint32_t>& desc_scratch = scr.desc_scratch;
    if (raw_scratch.size() < (size_t)raw_used * 16)
        raw_scratch.resize((size_t)raw_used * 16);
    if (desc_scratch.size() < desc_used) desc_scratch.resize(desc_used);

    uint32_t r = 0, dsc = 0, dcs = 0;
    for (int pi = 0; pi < 3; pi++) {
        PlaneOut& p = planes[pi];
        const size_t nb = (size_t)g.bh[pi] * g.bw[pi];
        for (size_t bi = 0; bi < nb; bi++) {
            const unsigned meta = p.meta[bi];
            const unsigned cls = (meta >> 5) & 1, mode = meta & 7;
            if (cls == 0 && mode != 6)
                // dc pool: threaded slices allocated slots in
                // nondeterministic order, but the values live in the dense
                // dc grid — rebuild the pool canonically from it
                pools->dc_pool[(size_t)dcs++ * pools->dc_stride] = p.dc[bi];
            if (cls == 0 && mode == 6) {
                std::memcpy(&raw_scratch[(size_t)r * 16],
                            pools->raw_pool
                                + (size_t)p.slot[bi] * pools->raw_stride,
                            16);
                p.slot[bi] = r++;
            } else {
                const unsigned k =
                    (cls == 1 || (mode >= 1 && mode <= 4)) ? mode : 0;
                if (!k) continue;
                const uint32_t old = p.slot[bi];
                for (unsigned j = 0; j < k; j++)
                    desc_scratch[dsc + j] = pools->desc_pool[
                        (size_t)(old + j) * pools->desc_stride];
                p.slot[bi] = dsc;
                dsc += k;
            }
        }
    }
    for (uint32_t i = 0; i < r; i++)
        std::memcpy(pools->raw_pool + (size_t)i * pools->raw_stride,
                    &raw_scratch[(size_t)i * 16], 16);
    for (uint32_t i = 0; i < dsc; i++)
        pools->desc_pool[(size_t)i * pools->desc_stride] = desc_scratch[i];
}

uint32_t rd32(const uint8_t* p) {
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
           ((uint32_t)p[2] << 8) | p[3];
}
uint16_t rd16(const uint8_t* p) { return (uint16_t)((p[0] << 8) | p[1]); }

}  // namespace

extern "C" int hvqm4_plan_frame(const uint8_t* payload, size_t n, int ftype,
                                int width, int height, int h_samp, int v_samp,
                                PlaneOut* planes /* [3] */, PoolOut* pools,
                                FrameOut* fout,
                                char* err_buf, size_t err_len) {
    try {
        std::atomic<uint32_t> raw_ctr{0}, desc_ctr{0}, dc_ctr{0};
        Geometry g;
        g.width = width;
        g.height = height;
        g.h_samp = h_samp;
        g.v_samp = v_samp;
        for (int p = 0; p < 3; p++) {
            g.pw[p] = p ? width / h_samp : width;
            g.ph[p] = p ? height / v_samp : height;
            g.bw[p] = g.pw[p] / 4;
            g.bh[p] = g.ph[p] / 4;
        }
        g.mh = height / 8;
        g.mw = width / 8;
        g.nest_h = width >= height ? 38 : 70;
        g.nest_w = width >= height ? 70 : 38;

        constexpr size_t FRAME_HDR = 12 + 4 * 6;
        if (n < FRAME_HDR) throw Error("payload shorter than frame header");
        fout->display_id = rd32(payload);
        fout->nest_x = rd16(payload + 4);
        fout->nest_y = rd16(payload + 6);
        fout->dc_shift = payload[8];
        const int S = payload[9] > 1 ? payload[9] : 1;
        if (fout->dc_shift > 7) throw Error("dc_shift out of range");
        if (S > g.mh) throw Error("slice count exceeds MB rows");
        if (rd16(payload + 10) != 0)
            throw Error("reserved frame-header field must be zero");

        size_t off = FRAME_HDR;
        const uint8_t* seg = nullptr;  // 6 x S u32 sub-table (FORMAT.md §9)
        if (S > 1) {
            size_t sub = 4u * 6 * (size_t)S;
            if (off + sub > n) throw Error("truncated slice sub-table");
            seg = payload + off;
            off += sub;
        }
        const uint8_t* sp[6];
        size_t sn[6];
        if (rd32(payload + 12 + 4 * 5) != 0)
            throw Error("reserved stream 5 must be empty");
        for (int i = 0; i < 6; i++) {
            sn[i] = rd32(payload + 12 + 4 * i);
            if (off + sn[i] > n) throw Error("stream overruns payload");
            sp[i] = payload + off;
            off += sn[i];
            if (seg) {
                size_t tot = 0;
                for (int sl = 0; sl < S; sl++)
                    tot += rd32(seg + 4 * (i * S + sl));
                if (tot != sn[i])
                    throw Error("slice segments do not sum to stream size");
            }
        }
        if (off != n) throw Error("trailing bytes after streams");

        // recycled scratch: mb_rows() fully initializes every entry it
        // covers, so no per-call zeroing is needed; reusing SliceDec
        // objects keeps their Huffman-table vectors' capacity (per-frame
        // construction showed up as ~5% of planning)
        ScratchLease lease;
        std::vector<MBInfo>& mbs = lease.s->mbs;
        if (ftype != 0 && mbs.size() < (size_t)g.mh * g.mw)
            mbs.resize((size_t)g.mh * g.mw);
        std::vector<SliceDec>& slices = lease.s->slices;
        if ((int)slices.size() < S) slices.resize(S);
        for (int sl = 0; sl < S; sl++) {
            SliceDec& d = slices[sl];
            d.bn_zero_run = 0;
            d.g = &g;
            d.pools = pools;
            d.raw_ctr = &raw_ctr;
            d.desc_ctr = &desc_ctr;
            d.dc_ctr = &dc_ctr;
            d.ftype = ftype;
            d.ms0 = sl * g.mh / S;
            d.ms1 = (sl + 1) * g.mh / S;
            d.mbs = mbs.data();
            const uint8_t* sd[6];
            size_t sl_len[6];
            for (int k = 0; k < 6; k++) {
                if (seg) {
                    size_t start = 0;
                    for (int i = 0; i < sl; i++)
                        start += rd32(seg + 4 * (k * S + i));
                    sd[k] = sp[k] + start;
                    sl_len[k] = rd32(seg + 4 * (k * S + sl));
                } else {
                    sd[k] = sp[k];
                    sl_len[k] = sn[k];
                }
            }
            d.bn.init(sd[0], sl_len[0]);
            d.dch.init(sd[1], sl_len[1]);
            d.aux.init(sd[2], sl_len[2]);
            d.mbt.init(sd[3], sl_len[3]);
            d.mvh.init(sd[4], sl_len[4]);
        }

        const int dc_shift = (int)fout->dc_shift;
        if (ftype == 0) {  // no MB scan on I frames: MV arrays read as zero
            std::memset(fout->mv, 0, (size_t)g.mh * g.mw * sizeof(uint32_t));
            std::memset(fout->mv2, 0,
                        (size_t)g.mh * g.mw * sizeof(uint32_t));
        }

        const char* tenv = std::getenv("HVQM4_PLANNER_THREADS");
        int want = (tenv && !g_in_step_worker) ? std::atoi(tenv) : 1;
        int n_threads = std::min<int>(S, std::max(want, 1));
        if (n_threads > 1) {
            // slices write disjoint block rows; errors collected per thread
            std::vector<std::string> errs(S);
            std::vector<std::thread> pool;
            std::atomic<int> next{0};
            for (int t = 0; t < n_threads; t++) {
                pool.emplace_back([&]() {
                    int sl;
                    while ((sl = next.fetch_add(1)) < S) {
                        try {
                            SliceDec& d = slices[sl];
                            if (d.ftype != 0) d.mb_rows(fout->mv, fout->mv2);
                            for (int pi = 0; pi < 3; pi++)
                                d.plane(pi, dc_shift, planes[pi]);
                        } catch (const std::exception& e) {
                            errs[sl] = e.what();
                        }
                    }
                });
            }
            for (auto& th : pool) th.join();
            for (auto& e : errs)
                if (!e.empty()) throw Error(e);
            // threads allocate pool slots in nondeterministic order; restore
            // the canonical numbering the device recomputes from meta
            compact_pools(g, planes, pools, raw_ctr.load(), desc_ctr.load(),
                          *lease.s);
        } else {
            // plane-MAJOR order (not slice-major): pool slots are then
            // allocated in exactly the canonical block scan order — plane 0
            // row-major, then planes 1, 2 — which lets the device (and
            // Python unpackers) recompute every raw/desc index as an
            // exclusive cumsum over meta-derived counts instead of
            // uploading a u32 index field per block. Each slice's streams
            // are its own readers, so interleaving slices between plane
            // passes is safe.
            // bound by S: the reused thread_local vector may be larger
            for (int sl = 0; sl < S; sl++)
                if (slices[sl].ftype != 0)
                    slices[sl].mb_rows(fout->mv, fout->mv2);
            for (int pi = 0; pi < 3; pi++)
                for (int sl = 0; sl < S; sl++)
                    slices[sl].plane(pi, dc_shift, planes[pi]);
        }

        fout->raw_used = raw_ctr.load();
        fout->desc_used = desc_ctr.load();
        fout->dc_used = dc_ctr.load();
        // value-presence bitmap via byte stores (a 1ull<<m OR chain is a
        // serial dependency that measurably slows the packing loop)
        uint8_t seen[64] = {0};
        for (int pi = 0; pi < 3; pi++) {
            const size_t nb = (size_t)g.bh[pi] * g.bw[pi];
            const uint8_t* m = planes[pi].meta;
            uint32_t* o = planes[pi].meta5;
            size_t bi = 0;
            for (; bi + 5 <= nb; bi += 5) {
                *o++ = (uint32_t)m[bi] | ((uint32_t)m[bi + 1] << 6)
                       | ((uint32_t)m[bi + 2] << 12)
                       | ((uint32_t)m[bi + 3] << 18)
                       | ((uint32_t)m[bi + 4] << 24);
                seen[m[bi]] = seen[m[bi + 1]] = seen[m[bi + 2]] = 1;
                seen[m[bi + 3]] = seen[m[bi + 4]] = 1;
            }
            if (bi < nb) {
                uint32_t w = 0;
                for (int j = 0; bi < nb; bi++, j += 6) {
                    w |= (uint32_t)m[bi] << j;
                    seen[m[bi]] = 1;
                }
                *o = w;
            }
        }
        uint64_t meta_mask = 0;
        for (int v = 0; v < 64; v++)
            if (seen[v]) meta_mask |= 1ull << v;
        fout->meta_mask = meta_mask;
        // mv variant flags cover the FIRST vector grid only (v6: refsel-2
        // second vectors ride the meta-derived pool, never a dense field)
        uint32_t any = 0, wide = 0, second = 0;
        const size_t nmb = (size_t)g.mh * g.mw;
        for (size_t i = 0; i < nmb; i++) {
            const uint32_t v = fout->mv[i];
            any |= v;
            second |= fout->mv2[i];
            // a s16 half fits s8 iff (half + 0x80) has no bits above 8
            wide |= ((v & 0xFFFF) + 0x80) & 0xFF00;
            wide |= ((v >> 16) + 0x80) & 0xFF00;
        }
        fout->mv_flags = (any ? 1u : 0u) | (wide ? 0u : 2u)
                         | (second ? 4u : 0u);
        // mv2 pool length: bi MBs by the device's carrier rule (luma meta
        // at the MB's top-left block, cls==1 & refsel==2)
        uint32_t carriers = 0;
        const int BW0 = g.bw[0];
        for (int my = 0; my < g.mh; my++)
            for (int mx = 0; mx < g.mw; mx++) {
                const uint8_t m = planes[0].meta[(size_t)(2 * my) * BW0
                                                 + 2 * mx];
                carriers += ((m >> 5) & 1) && (((m >> 3) & 3) == 2);
            }
        fout->mv2_carriers = carriers;
        if (ftype == 0) {  // nest from luma DC grid (FORMAT.md §6.1)
            const int BW = g.bw[0], BH = g.bh[0];
            for (int y = 0; y < g.nest_h; y++) {
                int ry = (int)((fout->nest_y + y) % BH);
                for (int x = 0; x < g.nest_w; x++) {
                    int rx = (int)((fout->nest_x + x) % BW);
                    fout->nest[y * g.nest_w + x] =
                        planes[0].dc[(size_t)ry * BW + rx];
                }
            }
        }
        return 0;
    } catch (const std::exception& e) {
        std::strncpy(err_buf, e.what(), err_len - 1);
        err_buf[err_len - 1] = 0;
        return 1;
    }
}

// ---------------------------------------------------------------------------
// Step-level batch API: plan one frame for each of N streams in a single
// call. Payload pointers may be null (inactive stream slots are skipped —
// the caller fills trivial plans itself). Each stream has its own PlaneOut
// triple, PoolOut and FrameOut. With HVQM4_PLANNER_THREADS > 1 the streams
// are distributed over a thread pool (each stream's entropy is independent).
// Returns 0 if every stream succeeded; otherwise the index+1 of the first
// failed stream, with its message in err_buf (the caller poisons just that
// stream and re-plans the step without it).
// ---------------------------------------------------------------------------

// FNV-1a over a byte range (oracle-compatible frame digest). Byte-serial by
// definition; here so the CLI/CI hash path runs at C speed instead of a
// Python per-byte loop (utils/hashing.py holds the fallback).
extern "C" uint32_t hvqm4_fnv1a(const uint8_t* d, size_t n, uint32_t h) {
    for (size_t i = 0; i < n; i++) {
        h ^= d[i];
        h *= 16777619u;
    }
    return h;
}

extern "C" int hvqm4_plan_step(const uint8_t* const* payloads,
                               const size_t* sizes, const int* ftypes,
                               int n_streams,
                               int width, int height, int h_samp, int v_samp,
                               PlaneOut* planes /* [n_streams*3] */,
                               PoolOut* pools /* [n_streams] */,
                               FrameOut* fouts /* [n_streams] */,
                               char* err_buf, size_t err_len) {
    std::vector<std::string> errs(n_streams);
    const char* tenv = std::getenv("HVQM4_PLANNER_THREADS");
    int want = tenv ? std::atoi(tenv) : 1;
    int n_threads = std::min<int>(n_streams, std::max(want, 1));

    auto run_one = [&](int si) {
        if (!payloads[si]) return;
        char ebuf[256];
        int rc = hvqm4_plan_frame(payloads[si], sizes[si], ftypes[si],
                                  width, height, h_samp, v_samp,
                                  planes + 3 * si, pools + si, fouts + si,
                                  ebuf, sizeof ebuf);
        if (rc != 0) errs[si] = ebuf;
    };

    if (n_threads > 1) {
        std::atomic<int> next{0};
        std::vector<std::thread> pool_t;
        for (int t = 0; t < n_threads; t++) {
            pool_t.emplace_back([&]() {
                g_in_step_worker = true;
                int si;
                while ((si = next.fetch_add(1)) < n_streams) run_one(si);
            });
        }
        for (auto& th : pool_t) th.join();
    } else {
        for (int si = 0; si < n_streams; si++) run_one(si);
    }
    for (int si = 0; si < n_streams; si++) {
        if (!errs[si].empty()) {
            std::strncpy(err_buf, errs[si].c_str(), err_len - 1);
            err_buf[err_len - 1] = 0;
            return si + 1;
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Step assembly: pack one shard's planned scratch into its staging rows
// (the variant's pool-tier regions + dense fields + mv encoding). This is
// the post-planning host work `multistream._assemble` used to do in a
// Python per-stream loop (measured 0.28-0.53 ms/step on the 1-vCPU box);
// one ctypes call per shard replaces ~50 numpy slice operations.
// Offsets are ELEMENT offsets into the staging rows, computed by
// `multistream._layout` for the step's chosen variant.
// ---------------------------------------------------------------------------

extern "C" {

struct AssembleArgs {
    uint8_t* st8;                // staging u8 row (this shard)
    uint32_t* st32;              // staging u32 row
    const uint8_t* raw;          // (nvl, raw_cap_full, 16) scratch
    const uint32_t* desc;        // (nvl, desc_cap_full)
    const uint8_t* dcp;          // (nvl, dc_cap_full)
    const int64_t* slot_used;    // (nvl, 4): raw/desc/dc/mv2 used per slot
    const uint32_t* offs;        // (nvl, 4): packed bases per slot —
                                 // raw B, dc B, nest B, u32 elem
    uint64_t nvl;
    uint64_t raw_cap_full, desc_cap_full, dc_cap_full;
    uint64_t offs_off;           // u32 layout offset of the offs field
    const uint8_t* new_nest;     // (nvl, nest_elems) scratch or null
    uint64_t nest_elems;         // per-slot nest size (nh*nw)
    const uint8_t* is_i;
    uint64_t isi_off;
    const uint8_t* is_ref;
    uint64_t isref_off;
    // dense per-plane meta grids (u8, (nvl, nb)) — the B-bit index source
    const uint8_t* meta_0; uint64_t meta_nb0, meta_off0;
    const uint8_t* meta_1; uint64_t meta_nb1, meta_off1;
    const uint8_t* meta_2; uint64_t meta_nb2, meta_off2;
    // planner-packed 6-bit words: the meta_bits==6 (no-codebook) fast path
    const uint32_t* meta5_0; const uint32_t* meta5_1; const uint32_t* meta5_2;
    const uint64_t* meta_mask;   // (nvl,) per-slot value masks
    uint64_t cb_off;             // u8 layout offset of the codebook field
    int32_t meta_bits;           // 3/4/5 codebook widths, 6 = raw escape
    int32_t mv_mode;             // 0 none, 1 packed8, 3 wide
    uint64_t mv_off;
    const uint32_t* mv;          // (nvl, mh*mw) packed y16|x16
    const uint32_t* mv2;
    uint64_t mv_per_stream;      // mh*mw
    uint64_t mb_w;               // mw (mv2 carrier scan)
    uint64_t luma_bw;            // luma block-grid width (carrier scan)
};

// Per-slot packed bases + region totals for one shard (the v5/v6 layout's
// pre-assembly pass): raw first (16-aligned segment starts), then dc,
// then nest bytes on I slots; u32 bases are cumsums of each slot's desc
// entries PLUS its refsel-2 mv2 pool words (v6: slot_used is (nvl, 4)).
// Replaces ~15 numpy ops per step in `multistream._assemble` (measured
// ~0.15 ms/step on the 1-vCPU box — real against a 2.2 ms/step C plan
// call).
void hvqm4_pack_offsets(const int64_t* slot_used, const uint8_t* is_i,
                        uint64_t nvl, uint64_t nest_elems,
                        uint32_t* offs, uint64_t* totals) {
    uint64_t o8 = 0, o32 = 0;
    for (uint64_t lv = 0; lv < nvl; lv++) {
        const uint64_t ru16 = (uint64_t)slot_used[lv * 4 + 0] * 16;
        const uint64_t du = (uint64_t)slot_used[lv * 4 + 1];
        const uint64_t cu = (uint64_t)slot_used[lv * 4 + 2];
        const uint64_t m2u = (uint64_t)slot_used[lv * 4 + 3];
        const uint64_t ne = is_i[lv] ? nest_elems : 0;
        uint32_t* o = offs + lv * 4;
        o[0] = (uint32_t)o8;
        o[1] = (uint32_t)(o8 + ru16);
        o[2] = (uint32_t)(o8 + ru16 + cu);
        o[3] = (uint32_t)o32;
        o8 += (ru16 + cu + ne + 15) & ~(uint64_t)15;
        o32 += du + m2u;
    }
    totals[0] = o8;
    totals[1] = o32;
}

void hvqm4_assemble_shard(const AssembleArgs* a) {
    const uint64_t m = a->mv_per_stream;
    const uint64_t mw = a->mb_w, mh = mw ? m / mw : 0;
    for (uint64_t lv = 0; lv < a->nvl; lv++) {
        const int64_t ru = a->slot_used[lv * 4 + 0];
        const int64_t du = a->slot_used[lv * 4 + 1];
        const int64_t cu = a->slot_used[lv * 4 + 2];
        const int64_t m2u = a->slot_used[lv * 4 + 3];
        const uint32_t* o = a->offs + lv * 4;
        if (ru)
            std::memcpy(a->st8 + o[0],
                        a->raw + lv * a->raw_cap_full * 16, (size_t)ru * 16);
        if (cu)
            std::memcpy(a->st8 + o[1],
                        a->dcp + lv * a->dc_cap_full, (size_t)cu);
        if (a->new_nest && a->is_i[lv])
            std::memcpy(a->st8 + o[2],
                        a->new_nest + lv * a->nest_elems, a->nest_elems);
        if (du)
            std::memcpy(a->st32 + o[3],
                        a->desc + lv * a->desc_cap_full, (size_t)du * 4);
        if (m2u) {
            // refsel-2 mv2 pool: one y16|x16 word per bi MB (the device's
            // carrier rule: luma meta at the MB top-left block, cls==1 &
            // refsel==2), appended after the slot's desc prefix
            uint32_t* out = a->st32 + o[3] + du;
            const uint32_t* v2 = a->mv2 + lv * m;
            const uint8_t* lm = a->meta_0 + lv * a->meta_nb0;
            int64_t left = m2u;
            for (uint64_t my = 0; my < mh && left; my++)
                for (uint64_t mx = 0; mx < mw && left; mx++) {
                    const uint8_t mb = lm[(2 * my) * a->luma_bw + 2 * mx];
                    if (((mb >> 5) & 1) && (((mb >> 3) & 3) == 2)) {
                        *out++ = v2[my * mw + mx];
                        left--;
                    }
                }
        }
    }
    std::memcpy(a->st32 + a->offs_off, a->offs, a->nvl * 4 * 4);
    std::memcpy(a->st8 + a->isi_off, a->is_i, a->nvl);
    std::memcpy(a->st8 + a->isref_off, a->is_ref, a->nvl);

    if (a->meta_bits == 6) {  // raw escape: planner-packed 6-bit words
        const uint32_t* m5s[3] = {a->meta5_0, a->meta5_1, a->meta5_2};
        const uint64_t nbs[3] = {a->meta_nb0, a->meta_nb1, a->meta_nb2};
        const uint64_t offs5[3] = {a->meta_off0, a->meta_off1, a->meta_off2};
        for (int pi = 0; pi < 3; pi++) {
            if (!m5s[pi]) continue;
            const uint64_t nw5 = (nbs[pi] + 4) / 5;
            std::memcpy(a->st32 + offs5[pi], m5s[pi], a->nvl * nw5 * 4);
        }
    } else {
        // per-slot codebook (set-bit values ascending, tail zero) + B-bit
        // indices packed 32/B per u32 — B-specialized so the per-word
        // lookup loop fully unrolls (this runs once per block; the generic
        // variable-bound version measured ~3 ns/block)
        const uint8_t* metas[3] = {a->meta_0, a->meta_1, a->meta_2};
        const uint64_t nbs[3] = {a->meta_nb0, a->meta_nb1, a->meta_nb2};
        const uint64_t moffs[3] = {a->meta_off0, a->meta_off1, a->meta_off2};
        const uint64_t cb_size = 1ull << a->meta_bits;
        auto pack = [&](auto bconst, const uint8_t* lut, const uint8_t* src,
                        uint64_t nb, uint32_t* out) {
            constexpr int B = decltype(bconst)::value;
            constexpr int PW = 32 / B;
            const uint64_t full = nb / PW;
            uint64_t bi = 0;
            for (uint64_t w = 0; w < full; w++, bi += PW) {
                uint32_t acc = lut[src[bi]];
                for (int j = 1; j < PW; j++)
                    acc |= (uint32_t)lut[src[bi + j]] << (B * j);
                out[w] = acc;
            }
            if (bi < nb) {
                uint32_t acc = 0;
                for (int j = 0; bi < nb; bi++, j++)
                    acc |= (uint32_t)lut[src[bi]] << (B * j);
                out[full] = acc;
            }
        };
        for (uint64_t lv = 0; lv < a->nvl; lv++) {
            uint8_t lut[64] = {0};
            uint8_t* cb = a->st8 + a->cb_off + lv * cb_size;
            std::memset(cb, 0, cb_size);
            uint64_t mask = a->meta_mask[lv];
            int nvals = 0;
            for (int v = 0; v < 64; v++)
                if (mask & (1ull << v)) {
                    lut[v] = (uint8_t)nvals;
                    cb[nvals++] = (uint8_t)v;
                }
            for (int pi = 0; pi < 3; pi++) {
                if (!metas[pi]) continue;
                const uint8_t* src = metas[pi] + lv * nbs[pi];
                const uint64_t nwm =
                    (nbs[pi] + (32 / a->meta_bits) - 1) / (32 / a->meta_bits);
                uint32_t* out = a->st32 + moffs[pi] + lv * nwm;
                switch (a->meta_bits) {
                    case 3: pack(std::integral_constant<int, 3>{}, lut, src,
                                 nbs[pi], out); break;
                    case 4: pack(std::integral_constant<int, 4>{}, lut, src,
                                 nbs[pi], out); break;
                    default: pack(std::integral_constant<int, 5>{}, lut, src,
                                  nbs[pi], out); break;
                }
            }
        }
    }

    const uint64_t N = a->nvl * m;
    if (a->mv_mode == 3) {  // WIDE: verbatim s16-pair words (mv only; mv2
        std::memcpy(a->st32 + a->mv_off, a->mv, N * 4);  // rides the pool)
    } else if (a->mv_mode == 1) {  // PACKED8: two MBs (x.s8,y.s8) per u32
        const uint64_t mwp = (m + 1) / 2;
        for (uint64_t lv = 0; lv < a->nvl; lv++) {
            const uint32_t* v = a->mv + lv * m;
            uint32_t* o = a->st32 + a->mv_off + lv * mwp;
            uint64_t i = 0;
            for (; i + 2 <= m; i += 2) {
                const uint32_t b0 = (v[i] & 0xFF) | (((v[i] >> 16) & 0xFF) << 8);
                const uint32_t b1 =
                    (v[i + 1] & 0xFF) | (((v[i + 1] >> 16) & 0xFF) << 8);
                o[i / 2] = b0 | (b1 << 16);
            }
            if (i < m)  // odd MB count: zero-padded high half
                o[i / 2] = (v[i] & 0xFF) | (((v[i] >> 16) & 0xFF) << 8);
        }
    }
}

}  // extern "C"
