// Native sampe per-read stage: SE selection, PE candidate expansion,
// pairing sweep and multi-hit selection.
//
// This compiles the hot per-read loops of the paired-end SAM stage that the
// reference runs as threaded C (bwape.c:238-297 + bwapair.c + saiset.c +
// filter_alignments.cpp) and that ibwa_tpu/sam/sampe.py implements in Python
// (the semantic source of truth for this file; sampe.py is itself the
// byte-parity port of the reference).  Python remains the orchestrator:
// batch I/O, insert-size inference, mate rescue, refinement and SAM text
// stay in ibwa_tpu/sam/sampe.py; this file only replaces the per-read inner
// loops (select_sai_ibwa, compute_seq_coords_and_counts, find_optimal_pair,
// select_sai_multi).
//
// Reference parity anchors:
//   select_sai_ibwa          bwape.c:299-369
//   compute_seq_coords...    filter_alignments.cpp:53-142
//   find_optimal_pair        bwapair.c:168-279
//   select_sai_multi         saiset.c:113-161
//   alngrp sort+filter       saiset.c:45-78
//   remap walks              bwaremap.cpp:140-311
//   bwa_approx_mapQ          bwase.c:111-120

#include <time.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "lf_step.h"

namespace {

// ---------------------------------------------------------------------------
// FM-index SA walk (duplicated from core.cpp's anonymous namespace)
// ---------------------------------------------------------------------------

struct InterleavedBwt {
  const uint32_t* data;
  uint32_t primary;
  uint32_t l2[5];
  uint32_t seq_len;
};

static inline uint32_t inv_psi(const InterleavedBwt& b, uint32_t k) {
  return ibwa_lf::lf_step(b.data, b.primary, b.l2, b.seq_len, k);
}

struct SaIndex {
  InterleavedBwt bwt;
  uint32_t sa_intv;
  uint32_t intv_shift;  // log2(sa_intv) when it is a power of two, else 0
  const uint32_t* sampled_sa;
};

// The walks are compute-bound here (the BWT is L3-resident: interleaving
// independent walks with prefetch measured a wash), so the win is per-step
// cost: a power-of-two sa_intv (bwa writes 32) replaces the 32-bit div in
// the loop test with a mask — ~26 cycles saved per LF step.
static inline uint32_t sa_walk(const SaIndex& s, uint32_t k) {
  uint32_t add = 0;
  if (s.intv_shift) {
    const uint32_t mask = s.sa_intv - 1;
    while (k & mask) {
      ++add;
      k = inv_psi(s.bwt, k);
    }
    return add + s.sampled_sa[k >> s.intv_shift];
  }
  while (k % s.sa_intv != 0) {
    ++add;
    k = inv_psi(s.bwt, k);
  }
  return add + s.sampled_sa[k / s.sa_intv];
}

// ---------------------------------------------------------------------------
// drand48 (exact libc LCG, matches ibwa_tpu/rng.py)
// ---------------------------------------------------------------------------

static const uint64_t R48_A = 0x5DEECE66DULL;
static const uint64_t R48_C = 0xBULL;
static const uint64_t R48_MASK = (1ULL << 48) - 1;

struct Rng {
  uint64_t x;
  double next() {
    x = (R48_A * x + R48_C) & R48_MASK;
    return (double)x * (1.0 / 281474976710656.0);
  }
};

// ---------------------------------------------------------------------------
// Per-db context
// ---------------------------------------------------------------------------

// remap cigar ops (preprocessed by sam/pe_native.py): same codes as the
// Python walker's character classes
enum RmOp { RM_M = 0, RM_X = 1, RM_EQ = 2, RM_N = 3, RM_D = 4, RM_I = 5 };

struct PeDb {
  SaIndex fwd, rev;       // fwd used for strand!=0, rev for strand==0
  uint32_t seq_len;       // == bwt seq_len (both strands)
  int64_t offset;         // global coordinate of base 0
  int64_t l_pac;
  int32_t n_seqs;
  const int64_t* ann_off;
  const int32_t* ann_len;
  bool has_remap;
  int32_t n_remap;        // number of remap records (contigs covered)
  const int32_t* rm_target;     // target contig index in db 0
  const uint8_t* rm_exact;
  const int64_t* rm_start;
  const int64_t* rm_stop;
  const int64_t* rm_run_begin;  // [n_remap] offsets into rm_ops/rm_lens
  const int32_t* rm_run_cnt;
  const uint8_t* rm_ops;
  const int32_t* rm_lens;
  // emit-time aux (registered via ibwa_pe_set_emit_db; null until then)
  const uint8_t* pac = nullptr;       // PACKED 2-bit codes (.pac bytes)
  int64_t n_holes = 0;                // .amb N-hole list (bns_coor_pac2real)
  const int64_t* amb_off = nullptr;
  const int32_t* amb_len = nullptr;
  const uint8_t* names = nullptr;     // concatenated contig names
  const int64_t* name_off = nullptr;  // [n_seqs + 1]
  const int32_t* rm_ngapo = nullptr;  // [n_remap] gap-opens per remap cigar
};

struct SaiBatch {
  const int32_t* counts;  // [n_reads]
  const uint32_t* recs;   // [tot, 4]: meta(nmm|gapo<<8|gape<<16|a<<24), k, l, score
  std::vector<int64_t> read_off;  // running offset per read (built lazily)
};

struct PeCtx {
  std::vector<PeDb> dbs;
  int remapping = 0;
  int32_t s_mm = 3;
  // registered .sai batches: [end][db]
  SaiBatch sai[2][16];
  int n_db = 0;
  int64_t l_pac_total = 0;   // sum of db l_pacs (dbset address space)
  std::string emit_buf;      // SAM text output of ibwa_pe_emit
  // SA-interval position cache (the reference's bwtcache, bwtcache.c:43-59
  // + filter_alignments.cpp:77-102): wide intervals recur across reads on
  // repeat-rich genomes; memoize the raw SA-walk values per
  // (db, strand, k, l) for intervals >= MIN_HASH_WIDTH.
  std::unordered_map<uint64_t, std::vector<uint32_t>> sa_cache[16][2];
  size_t cache_vals = 0;
  // set once ibwa_pe_prefill_walks has run (device-resolved walks):
  // cached_walk then consults the cache for EVERY width, not just wide
  // intervals — narrow prefilled entries must hit.
  bool prefilled = false;
};

// The reference caches >=1000-wide intervals (filter_alignments.cpp:10)
// because its cache has mutex costs; ours is single-threaded per batch,
// so caching every recurring interval >= 8 wide is strictly cheaper
// (pure function of (db, strand, k, l) — behavior-neutral).  A size cap
// bounds pathological corpora.
constexpr int64_t MIN_HASH_WIDTH = 8;  // deliberately lower than the
// reference's 1000 (filter_alignments.cpp:10) — see comment above
constexpr size_t CACHE_MAX_VALS = 64u << 20;  // 64M positions ~ 256 MB

// raw walk values for [k, l] of one db/strand, cached when wide
static const std::vector<uint32_t>& cached_walk(PeCtx& ctx, int dbidx,
                                                int strand, uint32_t k,
                                                uint32_t l,
                                                std::vector<uint32_t>& tmp) {
  const PeDb& db = ctx.dbs[dbidx];
  const SaIndex& idx = strand ? db.fwd : db.rev;
  int64_t width = (int64_t)l - k + 1;
  if (width < MIN_HASH_WIDTH && !ctx.prefilled) {
    tmp.clear();
    tmp.reserve(width);
    for (uint32_t s = k; s <= l; ++s) tmp.push_back(sa_walk(idx, s));
    return tmp;
  }
  uint64_t key = ((uint64_t)k << 32) | l;
  auto& slot = ctx.sa_cache[dbidx][strand];
  auto it = slot.find(key);
  if (it != slot.end()) return it->second;
  if (width < MIN_HASH_WIDTH) {  // prefill miss on a narrow interval
    tmp.clear();
    tmp.reserve(width);
    for (uint32_t s = k; s <= l; ++s) tmp.push_back(sa_walk(idx, s));
    return tmp;
  }
  std::vector<uint32_t> v;
  v.reserve(width);
  for (uint32_t s = k; s <= l; ++s) v.push_back(sa_walk(idx, s));
  if (ctx.cache_vals > CACHE_MAX_VALS) {
    tmp = std::move(v);
    return tmp;
  }
  ctx.cache_vals += (size_t)width;
  return slot.emplace(key, std::move(v)).first->second;
}

// global position -> local db sa2seq (bwtdb_sa2seq, dbset.c:239-246)
static int64_t sa2seq(const PeDb& db, int strand, uint32_t sa,
                      int64_t read_len) {
  if (strand) return db.offset + (int64_t)sa_walk(db.fwd, sa);
  int64_t v = (int64_t)sa_walk(db.rev, sa);
  return db.offset + (int64_t)db.seq_len - (v + read_len);
}

// bns_seq_for_pos (bntseq.c:278-294) — quirky midpoint binary search
static int32_t seq_for_pos(const PeDb& db, int64_t pac_coor) {
  int32_t left = 0, mid = 0, right = db.n_seqs;
  while (left < right) {
    mid = (left + right) >> 1;
    if (pac_coor >= db.ann_off[mid]) {
      if (mid == db.n_seqs - 1) break;
      if (pac_coor < db.ann_off[mid + 1]) break;
      left = mid + 1;
    } else {
      right = mid;
    }
  }
  return mid;
}

// remap_cigar (bwaremap.cpp:188-268): alt offset -> target offset
static bool remap_cigar_pos(const PeDb& db, int32_t seqid, int64_t pos,
                            int64_t seqlen, int64_t* out) {
  if (pos >= seqlen) {
    fprintf(stderr,
            "[remap_coordinates] requested pos %lld > sequence length %lld\n",
            (long long)pos, (long long)seqlen);
    return false;
  }
  const uint8_t* ops = db.rm_ops + db.rm_run_begin[seqid];
  const int32_t* lens = db.rm_lens + db.rm_run_begin[seqid];
  int32_t n = db.rm_run_cnt[seqid];
  int64_t altpos = 0, refpos = 0;
  int last_op = -1;
  int64_t last_len = 0;
  int32_t i = 0;
  while (altpos <= pos) {
    if (i >= n) break;
    last_len = lens[i];
    last_op = ops[i];
    ++i;
    if (last_op == RM_M || last_op == RM_X || last_op == RM_EQ) {
      refpos += last_len;
      altpos += last_len;
    } else if (last_op == RM_N || last_op == RM_D) {
      refpos += last_len;
    } else if (last_op == RM_I) {
      altpos += last_len;
    } else {
      fprintf(stderr, "invalid cigar character\n");
      return false;
    }
  }
  if (altpos > seqlen) return false;
  if (altpos == pos) {
    *out = refpos;
    return true;
  }
  if (altpos > pos) {
    if (last_op == RM_M || last_op == RM_X || last_op == RM_EQ) {
      *out = refpos - (altpos - pos);
      return true;
    }
    if (last_op == RM_I) {
      *out = refpos;
      return true;
    }
    return false;
  }
  return false;
}

// is_remapped_sequence_identical (bwaremap.cpp:140-186)
static int remap_identical(const PeDb& db, int32_t seqid, int64_t start,
                           int64_t length) {
  if (db.rm_exact[seqid]) return 1;
  const uint8_t* ops = db.rm_ops + db.rm_run_begin[seqid];
  const int32_t* lens = db.rm_lens + db.rm_run_begin[seqid];
  int32_t n = db.rm_run_cnt[seqid];
  int64_t pos = 0, last_len = 0;
  int last_op = -1;
  int32_t i = 0;
  while (pos <= start) {
    if (i >= n) break;
    last_len = lens[i];
    last_op = ops[i];
    ++i;
    if (last_op == RM_M || last_op == RM_X || last_op == RM_EQ ||
        last_op == RM_N || last_op == RM_D) {
      pos += last_len;
    } else if (last_op == RM_I) {
      // no position advance
    } else {
      return 0;
    }
  }
  if (pos > start) {
    // uint32 wrap quirk: (last_len - start) compared as uint32
    return (last_op == RM_M || last_op == RM_EQ) &&
                   ((uint32_t)(last_len - start) > (uint32_t)length)
               ? 1
               : 0;
  }
  return 0;
}

// bwa_remap_position_with_seqid (bwaremap.cpp:277-311); target == db 0
static int remap_position_with_seqid(const PeCtx& ctx, const PeDb& db,
                                     int64_t pac_coor, int32_t seqid,
                                     int64_t* out) {
  if (seqid >= db.n_remap) {
    fprintf(stderr, "No read mapping for sequence id %d\n", (int)seqid);
    exit(1);
  }
  int32_t target_idx = db.rm_target[seqid];
  if (target_idx < 0) {
    fprintf(stderr, "Failed to locate remapping target\n");
    exit(1);
  }
  int64_t rv;
  if (!db.rm_exact[seqid]) {
    int64_t altpos = pac_coor - db.ann_off[seqid];
    int64_t off;
    if (!remap_cigar_pos(db, seqid, altpos, (int64_t)db.ann_len[seqid], &off))
      return 0;
    rv = db.rm_start[seqid] + off;
  } else {
    rv = pac_coor - db.ann_off[seqid];
  }
  if (!db.rm_exact[seqid] &&
      (rv < db.rm_start[seqid] || rv > db.rm_stop[seqid])) {
    fprintf(stderr,
            "remapped position out of range (%lld should be in [%lld, %lld])\n",
            (long long)rv, (long long)db.rm_start[seqid],
            (long long)db.rm_stop[seqid]);
    exit(1);
  }
  *out = rv + ctx.dbs[0].ann_off[target_idx];
  return 1;
}

// the fields do_remap/remap_entry mutate (position_t / bwa_seq_t subset)
struct RemapIO {
  int64_t pos;
  int64_t remapped_pos;
  int32_t dbidx;
  int32_t remapped_seqid;
  int32_t remap_identical;
  int32_t n_gapo, n_gape;
  int64_t len;
};

// __remap (bwape.c:201-219) + the remap macro (bwape.c:223-235)
static int do_remap(const PeCtx& ctx, RemapIO* p, int dbidx) {
  p->dbidx = dbidx;
  const PeDb& db = ctx.dbs[dbidx];
  if (ctx.remapping) {
    if (!db.has_remap) {
      p->remapped_seqid = -1;
      p->remapped_pos = p->pos;
      return 1;
    }
    int64_t local = p->pos - db.offset;
    int32_t seqid = seq_for_pos(db, local);
    p->remapped_seqid = seqid;
    if (seqid >= db.n_remap) {
      fprintf(stderr, "No read mapping for sequence id %d\n", (int)seqid);
      exit(1);
    }
    int64_t x = 0;
    int status = remap_position_with_seqid(ctx, db, local, seqid, &x);
    p->remapped_pos = status ? x + ctx.dbs[0].offset : 0;
    int64_t gap = p->n_gapo + p->n_gape;
    int64_t relpos = local - db.ann_off[seqid];
    p->remap_identical =
        remap_identical(db, seqid, relpos > gap ? relpos - gap : 0,
                        p->len + gap);
    return status;
  }
  p->remapped_pos = p->pos;
  p->remapped_seqid = -1;
  return 0;
}

// ---------------------------------------------------------------------------
// alignment groups (saiset.c)
// ---------------------------------------------------------------------------

struct AlnRec {
  int32_t n_mm, n_gapo, n_gape, a;
  uint32_t k, l;
  int32_t score;
  int32_t dbidx;
};

// alngrp_create (saiset.c:45-78): merge per-db hits for read `ri` of end
// `end`, stable-sort by score and filter to best+s_mm when >1 db.
static void build_group(PeCtx& ctx, int end, int64_t ri,
                        std::vector<AlnRec>* out) {
  out->clear();
  for (int d = 0; d < ctx.n_db; ++d) {
    SaiBatch& sb = ctx.sai[end][d];
    int64_t off = sb.read_off[ri];
    int32_t cnt = sb.counts[ri];
    for (int32_t t = 0; t < cnt; ++t) {
      const uint32_t* r = sb.recs + (off + t) * 4;
      AlnRec a;
      a.n_mm = (int32_t)(r[0] & 0xFF);
      a.n_gapo = (int32_t)((r[0] >> 8) & 0xFF);
      a.n_gape = (int32_t)((r[0] >> 16) & 0xFF);
      a.a = (int32_t)((r[0] >> 24) & 1);
      a.k = r[1];
      a.l = r[2];
      a.score = (int32_t)r[3];
      a.dbidx = d;
      out->push_back(a);
    }
  }
  if (ctx.n_db > 1 && !out->empty()) {
    std::stable_sort(out->begin(), out->end(),
                     [](const AlnRec& x, const AlnRec& y) {
                       return x.score < y.score;
                     });
    int32_t best = (*out)[0].score;
    for (size_t i = 0; i < out->size(); ++i) {
      if ((*out)[i].score > best + ctx.s_mm) {
        out->resize(i);
        break;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// per-end-read scalar state (mirror of the AlnSeq fields the stage touches)
// ---------------------------------------------------------------------------

// i64 layout per end-read (stride 5)
enum { F_POS = 0, F_RPOS, F_SA, F_C1, F_C2, NF64 };
// i32 layout per end-read (stride 12)
enum {
  G_TYPE = 0, G_STRAND, G_NMM, G_NGAPO, G_NGAPE, G_SCORE,
  G_MAPQ, G_SEQ, G_DBIDX, G_RSEQID, G_RIDENT, G_XFLAG, NF32
};

enum { TYPE_NO_MATCH = 0, TYPE_UNIQUE = 1, TYPE_REPEAT = 2 };
enum { SAM_FPP = 2 };

struct Seq {
  int64_t* i64;
  int32_t* i32;
  int64_t len;       // clip_len
  int64_t full_len;
  int32_t max_diff;
};

static int g_log_n_tab[256];
static bool g_log_init = false;
static void init_g_log_n() {
  if (g_log_init) return;
  g_log_n_tab[0] = 0;
  for (int i = 1; i < 256; ++i)
    g_log_n_tab[i] = (int)(4.343 * std::log((double)i) + 0.5);
  g_log_init = true;
}

// bwa_approx_mapQ (bwase.c:111-120)
static int approx_mapQ(const Seq& s, int mm) {
  int64_t c1 = s.i64[F_C1], c2 = s.i64[F_C2];
  if (c1 == 0) return 23;
  if (c1 > 1) return 0;
  if (s.i32[G_NMM] == mm) return 25;
  if (c2 == 0) return 37;
  int n = c2 >= 255 ? 255 : (int)c2;
  return (23 < g_log_n_tab[n]) ? 0 : 23 - g_log_n_tab[n];
}

static void unmap_read(Seq& s) {
  s.i32[G_TYPE] = TYPE_NO_MATCH;
  s.i64[F_POS] = s.i64[F_RPOS] = s.i64[F_SA] = 0;
  s.i64[F_C1] = s.i64[F_C2] = 0;
}

// select_sai_ibwa (bwape.c:299-369)
static void select_sai_ibwa(PeCtx& ctx, const std::vector<AlnRec>& ag,
                            Seq& s, Rng& rng) {
  if (ag.empty()) {
    unmap_read(s);
    return;
  }
  int64_t n = (int64_t)ag.size();
  int64_t main_idx = 0;
  bool selected = false;
  double rng_cache = 0.0;
  int32_t best = ag[0].score;
  int64_t cnt = 0;
  int64_t i = 0;
  while (i < n) {
    const AlnRec& p = ag[i];
    int64_t naln = (int64_t)p.l - (int64_t)p.k + 1;
    if (p.score > best) break;
    if (rng.next() * (double)(naln + cnt) > (double)cnt) {
      main_idx = i;
      rng_cache = rng.next();
    }
    cnt += naln;
    ++i;
  }
  int64_t group_start = main_idx;
  int64_t top_end = i;

  s.i64[F_C1] = cnt;
  for (int64_t t = top_end; t < n; ++t)
    cnt += (int64_t)ag[t].l - (int64_t)ag[t].k + 1;
  s.i64[F_C2] = cnt - s.i64[F_C1];
  if (s.i64[F_C1] != 0)
    s.i32[G_TYPE] = s.i64[F_C1] > 1 ? TYPE_REPEAT : TYPE_UNIQUE;

  while (true) {
    const AlnRec& p = ag[main_idx];
    int64_t num = (int64_t)p.l - (int64_t)p.k + 1;
    int64_t start_idx = (int64_t)(rng_cache * (double)num);
    int64_t aidx = start_idx;
    while (true) {
      s.i64[F_SA] = (int64_t)p.k + aidx;
      s.i32[G_NMM] = p.n_mm;
      s.i32[G_NGAPO] = p.n_gapo;
      s.i32[G_NGAPE] = p.n_gape;
      s.i32[G_STRAND] = p.a;
      s.i32[G_SCORE] = p.score;
      s.i64[F_POS] =
          sa2seq(ctx.dbs[p.dbidx], p.a, (uint32_t)s.i64[F_SA], s.len);
      RemapIO rio;
      rio.pos = s.i64[F_POS];
      rio.n_gapo = s.i32[G_NGAPO];
      rio.n_gape = s.i32[G_NGAPE];
      rio.len = s.len;
      int status = do_remap(ctx, &rio, p.dbidx);
      s.i32[G_DBIDX] = rio.dbidx;
      s.i64[F_RPOS] = rio.remapped_pos;
      s.i32[G_RSEQID] = rio.remapped_seqid;
      s.i32[G_RIDENT] = rio.remap_identical;
      if (status == 1) {
        selected = true;
        break;
      }
      ++aidx;
      if (aidx >= num) aidx = 0;
      if (aidx == start_idx) break;
    }
    ++i;
    if (i >= top_end) i = 0;
    if (selected || i == group_start) break;
  }

  if (!selected) {
    unmap_read(s);
    fprintf(stderr, "Failed to select primary alignment\n");
    return;
  }
  int q = approx_mapQ(s, s.max_diff);
  s.i32[G_SEQ] = s.i32[G_MAPQ] = q;
}

// ---------------------------------------------------------------------------
// PE stage: candidate expansion + pairing (bwapair.c / filter_alignments.cpp)
// ---------------------------------------------------------------------------

struct Position {
  uint64_t pos;
  uint64_t remapped_pos;
  int32_t idx_and_end;
  int32_t dbidx;
  int32_t remapped_seqid;
  int32_t remap_identical;
  int32_t n_gapo, n_gape;
  int64_t len;
  int32_t score;
};

static const uint64_t U64MAX = ~0ULL;

// hash_64 (bwapair.c:13-20)
static uint64_t hash_64(uint64_t key) {
  key = key + ~(key << 32);
  key ^= key >> 22;
  key = key + ~(key << 13);
  key ^= key >> 8;
  key = key + (key << 3);
  key ^= key >> 15;
  key = key + ~(key << 27);
  key ^= key >> 31;
  return key;
}

struct IsizeC {
  double avg, std, ap_prior;
  int64_t low, high, high_bayesian;
};

struct PairOptC {
  int64_t max_isize;
  int32_t n_multi, N_multi;
  int32_t s_mm;
};

// compute_seq_coords_and_counts (filter_alignments.cpp:53-142)
static void compute_coords(PeCtx& ctx, const std::vector<AlnRec> aln[2],
                           Seq* p, std::vector<Position>* arr) {
  arr->clear();
  for (int j = 0; j < 2; ++j) {
    // remapped_pos -> best-score group record (first wins ties)
    std::unordered_map<uint64_t, int32_t> pos2score;  // value: score
    int32_t min_score = INT32_MAX;
    for (size_t k = 0; k < aln[j].size(); ++k) {
      const AlnRec& ar = aln[j][k];
      if (ar.score < min_score) min_score = ar.score;
      const PeDb& db = ctx.dbs[ar.dbidx];
      std::vector<uint32_t> tmp;
      const std::vector<uint32_t>& walks =
          cached_walk(ctx, ar.dbidx, ar.a, ar.k, ar.l, tmp);
      for (uint64_t sa = ar.k; sa <= (uint64_t)ar.l; ++sa) {
        uint32_t wv = walks[sa - ar.k];
        int64_t pos = ar.a ? db.offset + (int64_t)wv
                           : db.offset + (int64_t)db.seq_len -
                                 ((int64_t)wv + p[j].len);
        if (pos < db.offset || pos >= db.offset + db.l_pac) continue;
        Position ap;
        ap.pos = (uint64_t)pos;
        ap.remapped_pos = 0;
        ap.idx_and_end = ((int32_t)k << 1) | j;
        ap.dbidx = 0;
        ap.remapped_seqid = -1;
        ap.remap_identical = 0;
        ap.n_gapo = ar.n_gapo;
        ap.n_gape = ar.n_gape;
        ap.len = p[j].len;
        ap.score = ar.score;
        RemapIO rio;
        rio.pos = pos;
        rio.n_gapo = ap.n_gapo;
        rio.n_gape = ap.n_gape;
        rio.len = ap.len;
        int status = do_remap(ctx, &rio, ar.dbidx);
        ap.dbidx = rio.dbidx;
        ap.remapped_pos = (uint64_t)rio.remapped_pos;
        ap.remapped_seqid = rio.remapped_seqid;
        ap.remap_identical = rio.remap_identical;
        if (!status) continue;
        arr->push_back(ap);
        auto it = pos2score.find(ap.remapped_pos);
        if (it == pos2score.end())
          pos2score.emplace(ap.remapped_pos, ar.score);
        else if (ar.score < it->second)
          it->second = ar.score;
      }
    }
    int64_t total[2] = {0, 0};
    for (auto& kv : pos2score) total[kv.second == min_score ? 0 : 1] += 1;
    p[j].i64[F_C1] = total[0];
    p[j].i64[F_C2] = total[1];
    if (p[j].i64[F_C1] != 0)
      p[j].i32[G_TYPE] = p[j].i64[F_C1] > 1 ? TYPE_REPEAT : TYPE_UNIQUE;
  }
}

static bool mappings_overlap(const Position& a, const Position& b) {
  if (a.pos == U64MAX || b.pos == U64MAX) return false;
  return a.remapped_pos == b.remapped_pos &&
         (a.idx_and_end & 1) == (b.idx_and_end & 1);
}

// select_mapping (bwapair.c:62-96); n_optimal stays 1 as in the C
static const Position* select_mapping(const std::vector<Position>& arr,
                                      int64_t begin, int64_t end) {
  const Position* best = &arr[begin];
  std::unordered_set<uint64_t> seen;
  if (arr[0].pos == arr[0].remapped_pos) seen.insert(arr[0].pos);
  for (int64_t i = begin + 1; i <= end; ++i) {
    const Position& p = arr[i];
    if (p.pos == p.remapped_pos) {
      seen.insert(p.pos);
    } else {
      if (seen.count(p.remapped_pos) && p.remap_identical) continue;
    }
    if (p.score < best->score) best = &p;
  }
  return best;
}

struct PairingState {
  int64_t o_n = 0, subo_n = 0, cnt_chg = 0;
  int64_t max_len;
  Position dummy;
  const Position* last_pos[2][2];
  const Position* o_pos[2] = {nullptr, nullptr};
  uint64_t o_score = U64MAX, subo_score = U64MAX;
  PairingState(int64_t ml) : max_len(ml) {
    dummy.pos = U64MAX;
    dummy.remapped_pos = U64MAX;
    dummy.idx_and_end = 0;
    last_pos[0][0] = last_pos[0][1] = &dummy;
    last_pos[1][0] = last_pos[1][1] = &dummy;
  }
};

// pairing_aux (bwapair.c:98-147)
static void pairing_aux(Seq* p, const PairOptC& opt, const IsizeC& ii,
                        PairingState& st, const Position* u,
                        const Position* v, int64_t n_optimal) {
  uint64_t l;
  if (u->remapped_pos != u->pos && v->remapped_pos != v->pos &&
      u->dbidx == v->dbidx && u->remapped_seqid == v->remapped_seqid) {
    l = (v->pos + (uint64_t)p[v->idx_and_end & 1].len - u->pos) & 0xFFFFFFFFULL;
  } else {
    l = (v->remapped_pos + (uint64_t)p[v->idx_and_end & 1].len -
         u->remapped_pos) & 0xFFFFFFFFULL;
  }
  bool ok = u->remapped_pos != U64MAX && v->remapped_pos > u->remapped_pos &&
            (int64_t)l >= st.max_len &&
            ((ii.high && (int64_t)l <= ii.high_bayesian) ||
             (ii.high == 0 && (int64_t)l <= opt.max_isize));
  if (!ok) return;
  uint64_t s = (uint64_t)(v->score + u->score);
  s *= 10;
  if (ii.high) {
    double z = std::fabs((double)l - ii.avg) / ii.std / std::sqrt(2.0);
    s += (uint64_t)(int64_t)(-4.343 * std::log(0.5 * std::erfc(z)) + 0.499);
  }
  s = (s << 32) | (hash_64((u->remapped_pos << 32) | v->remapped_pos) &
                   0xFFFFFFFFULL);

  if ((s >> 32) == (st.o_score >> 32)) {
    st.o_n += n_optimal;
  } else if ((s >> 32) < (st.o_score >> 32)) {
    st.subo_n += st.o_n;
    st.o_n = n_optimal;
  } else {
    st.subo_n += 1;
  }

  if (s < st.o_score) {
    st.subo_score = st.o_score;
    st.o_score = s;
    st.o_pos[u->idx_and_end & 1] = u;
    st.o_pos[v->idx_and_end & 1] = v;
  } else if (s < st.subo_score) {
    st.subo_score = s;
  }
}

// pairing_aux2 (bwapair.c:149-163)
static void pairing_aux2(const std::vector<AlnRec> aln[2], PairingState& st,
                         Seq& read, const Position* pos) {
  const AlnRec& r = aln[pos->idx_and_end & 1][pos->idx_and_end >> 1];
  read.i32[G_XFLAG] |= SAM_FPP;
  if ((uint64_t)read.i64[F_POS] != pos->pos || read.i32[G_STRAND] != r.a) {
    read.i32[G_NMM] = r.n_mm;
    read.i32[G_NGAPO] = r.n_gapo;
    read.i32[G_NGAPE] = r.n_gape;
    read.i32[G_STRAND] = r.a;
    read.i32[G_SCORE] = r.score;
    read.i64[F_POS] = (int64_t)pos->pos;
    read.i32[G_DBIDX] = pos->dbidx;
    read.i64[F_RPOS] = (int64_t)pos->remapped_pos;
    read.i32[G_RSEQID] = pos->remapped_seqid;
    if (read.i32[G_MAPQ] > 0) st.cnt_chg += 1;
  }
}

// find_optimal_pair (bwapair.c:168-279)
static int64_t find_optimal_pair(PeCtx& ctx, Seq* p,
                                 std::vector<Position>& arr,
                                 const std::vector<AlnRec> aln[2],
                                 const PairOptC& opt, const IsizeC& ii) {
  PairingState st(std::max(p[0].full_len, p[1].full_len));
  std::stable_sort(arr.begin(), arr.end(),
                   [](const Position& a, const Position& b) {
                     if (a.remapped_pos != b.remapped_pos)
                       return a.remapped_pos < b.remapped_pos;
                     return a.pos < b.pos;
                   });
  int64_t n = (int64_t)arr.size();
  int64_t i = 0;
  while (i < n) {
    const Position* pos = &arr[i];
    const AlnRec& a = aln[pos->idx_and_end & 1][pos->idx_and_end >> 1];
    int32_t strand = a.a;
    int64_t n_optimal = 1;
    if (i < n - 1) {
      int64_t k = i;
      while (k + 1 < n && mappings_overlap(*pos, arr[k + 1])) ++k;
      if (k > i) {
        pos = select_mapping(arr, i, k);
        n_optimal = 1;
        i = k;
      }
    }
    if (strand == 1) {
      int y = 1 - (pos->idx_and_end & 1);
      pairing_aux(p, opt, ii, st, st.last_pos[y][1], pos, n_optimal);
      pairing_aux(p, opt, ii, st, st.last_pos[y][0], pos, n_optimal);
    } else {
      int e = pos->idx_and_end & 1;
      st.last_pos[e][0] = st.last_pos[e][1];
      st.last_pos[e][1] = pos;
    }
    ++i;
  }

  if (st.o_score != U64MAX) {
    int64_t mapQ_p = 0;
    if (st.o_n == 1) {
      if (st.subo_score == U64MAX) {
        mapQ_p = 29;
      } else if ((int64_t)((st.subo_score >> 32) - (st.o_score >> 32)) >
                 (int64_t)opt.s_mm * 10) {
        mapQ_p = 23;
      } else {
        int nn = st.subo_n < 255 ? (int)st.subo_n : 255;
        mapQ_p = (int64_t)((st.subo_score >> 32) - (st.o_score >> 32)) / 2 -
                 g_log_n_tab[nn];
        if (mapQ_p < 0) mapQ_p = 0;
      }
    }
    int32_t rr[2];
    for (int j = 0; j < 2; ++j) {
      const Position* op = st.o_pos[j];
      rr[j] = aln[op->idx_and_end & 1][op->idx_and_end >> 1].a;
    }
    bool same0 = (uint64_t)p[0].i64[F_RPOS] == st.o_pos[0]->remapped_pos &&
                 p[0].i32[G_STRAND] == rr[0];
    bool same1 = (uint64_t)p[1].i64[F_RPOS] == st.o_pos[1]->remapped_pos &&
                 p[1].i32[G_STRAND] == rr[1];
    if (same0 && same1) {
      if (p[0].i32[G_MAPQ] > 0 && p[1].i32[G_MAPQ] > 0) {
        int mq = p[0].i32[G_MAPQ] + p[1].i32[G_MAPQ];
        if (mq > 60) mq = 60;
        p[0].i32[G_MAPQ] = p[1].i32[G_MAPQ] = mq;
      } else {
        if (p[0].i32[G_MAPQ] == 0)
          p[0].i32[G_MAPQ] = std::min<int64_t>(mapQ_p + 7, p[1].i32[G_MAPQ]);
        if (p[1].i32[G_MAPQ] == 0)
          p[1].i32[G_MAPQ] = std::min<int64_t>(mapQ_p + 7, p[0].i32[G_MAPQ]);
      }
    } else if (same0) {  // end 1 moved
      p[1].i32[G_SEQ] = 0;
      p[1].i32[G_MAPQ] = std::min<int64_t>(p[0].i32[G_MAPQ], mapQ_p);
    } else if (same1) {  // end 0 moved
      p[0].i32[G_SEQ] = 0;
      p[0].i32[G_MAPQ] = std::min<int64_t>(p[1].i32[G_MAPQ], mapQ_p);
    } else {  // both moved
      p[0].i32[G_SEQ] = p[1].i32[G_SEQ] = 0;
      mapQ_p = std::max<int64_t>(mapQ_p - 20, 0);
      p[0].i32[G_MAPQ] = p[1].i32[G_MAPQ] = (int32_t)mapQ_p;
    }
    pairing_aux2(aln, st, p[0], st.o_pos[0]);
    pairing_aux2(aln, st, p[1], st.o_pos[1]);
  }
  return st.cnt_chg;
}

// select_sai_multi (saiset.c:113-161)
static void select_sai_multi(PeCtx& ctx, const std::vector<AlnRec>& ag,
                             Seq& s, int64_t n_multi, Rng& rng,
                             int64_t* out_pos, int32_t* out_meta,
                             int32_t* out_cnt, int64_t cap) {
  *out_cnt = 0;
  int64_t n_occ = 0;
  for (const AlnRec& q : ag) n_occ += (int64_t)q.l - (int64_t)q.k + 1;
  if (n_occ > n_multi + 1) return;
  int64_t rest = n_occ;
  struct M {
    int64_t pos;
    int32_t gap, mm, strand, dbidx;
  };
  std::vector<M> z;
  for (const AlnRec& q : ag) {
    const PeDb& db = ctx.dbs[q.dbidx];
    int64_t width = (int64_t)q.l - (int64_t)q.k + 1;
    if (width <= rest) {
      for (uint64_t sa = q.k; sa <= (uint64_t)q.l; ++sa) {
        int64_t pos = sa2seq(db, q.a, (uint32_t)sa, s.len);
        z.push_back({pos, q.n_gapo + q.n_gape, q.n_mm, q.a, q.dbidx});
      }
      rest -= width;
    } else {  // "we never come here" (saiset.c:150)
      int64_t j = rest;
      int64_t i2 = width;
      while (j > 0) {
        double pp = 1.0;
        double x = rng.next();
        while (x < pp) {
          pp -= pp * (double)j / (double)i2;
          --i2;
        }
        int64_t pos = sa2seq(db, q.a, (uint32_t)(q.l - 1), s.len);
        z.push_back({pos, q.n_gapo + q.n_gape, q.n_mm, q.a, q.dbidx});
        --j;
      }
      break;
    }
  }
  int64_t cnt = 0;
  for (const M& m : z) {
    if (m.pos == s.i64[F_POS]) continue;
    if (cnt >= n_multi || cnt >= cap) break;
    out_pos[cnt] = m.pos;
    out_meta[cnt * 4 + 0] = m.gap;
    out_meta[cnt * 4 + 1] = m.mm;
    out_meta[cnt * 4 + 2] = m.strand;
    out_meta[cnt * 4 + 3] = m.dbidx;
    ++cnt;
  }
  *out_cnt = (int32_t)cnt;
}

}  // namespace

// ---------------------------------------------------------------------------
// Emit stage: gapped refinement, MD/NM, trimming correction and SAM record
// assembly — the native port of bwa_refine_gapped + bwa_cal_md1 +
// bwa_correct_trimmed + bwa_print_sam1 (bwase.c:333-581) and sampe's
// post-stage loop (bwape.c:476-537).  The Python modules sam/bwase.py and
// sam/sampe.py remain the semantic source of truth (IBWA_PURE_PY=1).
// ---------------------------------------------------------------------------

extern "C" int32_t ibwa_global_aln(const uint8_t*, int32_t, const uint8_t*,
                                   int32_t, int32_t, int32_t, int32_t,
                                   int32_t, const int32_t*, int32_t,
                                   uint32_t*, int32_t, int32_t*);
extern "C" int64_t ibwa_cal_md(const uint32_t*, int32_t, const uint8_t*,
                               int64_t, int64_t, int64_t, const uint8_t*,
                               int32_t, char*, int64_t, int32_t*);

namespace {

enum { TYPE_MATESW = 3 };
enum {
  SAM_FSU = 4, SAM_FMU = 8, SAM_FSR = 16, SAM_FMR = 32
};
constexpr int CIG_M = 0, CIG_I = 1, CIG_D = 2, CIG_S = 3;

inline int cig_op(uint32_t c) { return (int)(c >> 29); }
inline int64_t cig_len(uint32_t c) { return (int64_t)(c & 0x1FFFFFFF); }
inline uint32_t cig_make(int op, int64_t len) {
  return ((uint32_t)op << 29) | (uint32_t)len;
}

// aln_sm_maq + aln_param_bwa (stdaln.c:212-227), the refinement params
static const int32_t kSmMaq[25] = {11, -19, -19, -19, -13, -19, 11, -19,
                                   -19, -13, -19, -19, 11, -19, -13, -19,
                                   -19, -19, 11, -13, -13, -13, -13, -13,
                                   -13};
constexpr int32_t kGapOpen = 26, kGapExt = 9, kGapEnd = 5, kBand = 50;

static int coord2idx_g(const PeCtx& ctx, int64_t pos) {
  // dbset coord2idx (dbset.c:17-39): last db whose offset <= pos
  int idx = 0;
  for (int i = 1; i < ctx.n_db; ++i)
    if (ctx.dbs[i].offset <= pos) idx = i;
  return idx;
}

// dbset_extract_sequence (dbset.c:306-325): cross-db, truncated at l_pac.
// pac is the packed .pac byte image: base p = (pac[p>>2] >> ((~p&3)<<1)) & 3
static int64_t extract_sequence(const PeCtx& ctx, int64_t beg, int64_t length,
                                std::vector<uint8_t>* out) {
  out->resize(length);
  int64_t total = 0;
  while (total < length) {
    if (beg >= ctx.l_pac_total) break;
    const PeDb& db = ctx.dbs[coord2idx_g(ctx, beg)];
    int64_t pos = beg - db.offset;
    int64_t take = std::min(length - total, db.l_pac - pos);
    uint8_t* dst = out->data() + total;
    for (int64_t i = 0; i < take; ++i) {
      int64_t p = pos + i;
      dst[i] = (db.pac[p >> 2] >> ((~p & 3) << 1)) & 3;
    }
    total += take;
    beg += take;
  }
  out->resize(total);
  return total;
}

// remap_position_with_seqid giving the LOCAL target offset (no db-0 offset);
// mirrors sam/remap.py::remap_position_with_seqid which raises on range
// errors (the reference err_fatals, bwaremap.cpp:305-309)
static int remap_pos_local(const PeCtx& ctx, const PeDb& db, int64_t pac_coor,
                           int32_t seqid, int64_t* out) {
  if (seqid >= db.n_remap) {
    fprintf(stderr, "No read mapping for sequence id %d\n", (int)seqid);
    exit(1);
  }
  int32_t target_idx = db.rm_target[seqid];
  if (target_idx < 0) {
    fprintf(stderr, "Failed to locate remapping target\n");
    exit(1);
  }
  int64_t rv;
  if (!db.rm_exact[seqid]) {
    int64_t altpos = pac_coor - db.ann_off[seqid];
    int64_t off;
    if (!remap_cigar_pos(db, seqid, altpos, (int64_t)db.ann_len[seqid], &off))
      return 0;
    rv = db.rm_start[seqid] + off;
  } else {
    rv = pac_coor - db.ann_off[seqid];
  }
  if (!db.rm_exact[seqid] &&
      (rv < db.rm_start[seqid] || rv > db.rm_stop[seqid])) {
    fprintf(stderr,
            "remapped position out of range (%lld should be in [%lld, %lld])\n",
            (long long)rv, (long long)db.rm_start[seqid],
            (long long)db.rm_stop[seqid]);
    exit(1);
  }
  *out = rv + ctx.dbs[0].ann_off[target_idx];
  return 1;
}

// dbset_extract_remapped (dbset.c:261-304): stitch primary flanks around
// the alt contig; degenerates to extract_sequence without a remap
static void extract_remapped(const PeCtx& ctx, int dbidx, int32_t seqid,
                             int64_t beg, int64_t length,
                             std::vector<uint8_t>* out) {
  const PeDb& db = ctx.dbs[dbidx];
  if (seqid < 0 || !db.has_remap) {
    extract_sequence(ctx, beg, length, out);
    return;
  }
  out->clear();
  out->reserve(length);
  std::vector<uint8_t> seg;
  int64_t seq_begin = db.offset + db.ann_off[seqid];
  int64_t total = 0;
  const PeDb& target = ctx.dbs[0];

  if (beg < seq_begin) {
    int64_t remapped_begin = 0;
    int status =
        remap_pos_local(ctx, db, db.ann_off[seqid], seqid, &remapped_begin);
    remapped_begin += target.offset;
    int64_t sublen = seq_begin - beg;
    int64_t offset = remapped_begin - sublen;
    if (sublen > remapped_begin || status == 0) {
      fprintf(stderr, "request too far ahead of remapped region\n");
      exit(1);
    }
    extract_sequence(ctx, offset, sublen, &seg);
    out->insert(out->end(), seg.begin(), seg.end());
    total += (int64_t)seg.size();
  }
  if (total < length) {
    int64_t sublen = length - total;
    if (sublen > (int64_t)db.ann_len[seqid]) sublen = db.ann_len[seqid];
    extract_sequence(ctx, beg, sublen, &seg);
    out->insert(out->end(), seg.begin(), seg.end());
    total += (int64_t)seg.size();
  }
  if (total < length) {
    int64_t rend = 0;
    int status = remap_pos_local(
        ctx, db, db.ann_off[seqid] + db.ann_len[seqid] - 1, seqid, &rend);
    if (status == 0) {
      fprintf(stderr, "request too far ahead of remapped region\n");
      exit(1);
    }
    int64_t remapped_end = rend + target.offset + 1;
    extract_sequence(ctx, remapped_end, length - total, &seg);
    out->insert(out->end(), seg.begin(), seg.end());
    total += (int64_t)seg.size();
  }
  if (total != length) {
    fprintf(stderr, "logic error: got %lld bases instead of %lld\n",
            (long long)total, (long long)length);
    exit(1);
  }
}

// dbset_coor_pac2real (dbset.c:247-255) + bns_coor_pac2real
// (bntseq.c:296-318): global pos -> (nn, seqid, dbidx)
static void coor_pac2real(const PeCtx& ctx, int64_t pos, int64_t length,
                          int64_t* nn_out, int32_t* seqid_out,
                          int32_t* dbidx_out) {
  int idx = coord2idx_g(ctx, pos);
  const PeDb& db = ctx.dbs[idx];
  int64_t local = pos - db.offset;
  int32_t seqid = seq_for_pos(db, local);
  // hole overlap: binary search counting only the FIRST overlapping hole
  int64_t left = 0, right = db.n_holes, nn = 0;
  while (left < right) {
    int64_t mid = (left + right) >> 1;
    int64_t ho = db.amb_off[mid];
    int64_t hl = db.amb_len[mid];
    if (local >= ho + hl) {
      left = mid + 1;
    } else if (local + length <= ho) {
      right = mid;
    } else {
      if (local >= ho) {
        nn += (ho + hl < local + length) ? ho + hl - local : length;
      } else {
        nn += (ho + hl < local + length) ? hl : length - (ho - local);
      }
      break;
    }
  }
  *nn_out = nn;
  *seqid_out = seqid;
  *dbidx_out = idx;
}

// translate_cigar (translate_cigar.cpp:71-357 / sam/remap.py::_translate):
// compose the read's cigar with the contig's remap cigar.  Returns false on
// any error (the C++ catch-all -> cigar dropped).
struct CigBuilder {
  std::vector<uint32_t> c;
  void push(int op, int64_t len) {
    if (!c.empty() && cig_op(c.back()) == op)
      c.back() = cig_make(op, cig_len(c.back()) + len);
    else
      c.push_back(cig_make(op, len));
  }
};

static bool translate_cigar_c(const PeDb& db, int32_t seqid, int64_t start,
                              const uint32_t* read_cig, int32_t n_read_cig,
                              int64_t total_read_len,
                              std::vector<uint32_t>* out) {
  const uint8_t* ops = db.rm_ops + db.rm_run_begin[seqid];
  const int32_t* lens = db.rm_lens + db.rm_run_begin[seqid];
  int32_t n_runs = db.rm_run_cnt[seqid];
  CigBuilder cb;
  int32_t si = 0;
  int64_t seq_len = 0;
  int seq_op = -1;
  bool seq_exhausted = false;
  auto seq_advance = [&]() {
    if (si < n_runs) {
      seq_len = lens[si];
      seq_op = ops[si];
      ++si;
    } else {
      seq_len = 0;
      seq_op = -1;
      seq_exhausted = true;
    }
  };
  int32_t ri = 0;
  int64_t read_len = 0;
  int read_op = 0;
  auto read_advance = [&]() {
    if (read_cig == nullptr) return;
    read_len = cig_len(read_cig[ri]);
    read_op = cig_op(read_cig[ri]);
    ++ri;
  };
  seq_advance();
  read_advance();
  auto eos = [&]() { return seq_len == 0 && seq_exhausted; };
  auto eor = [&]() { return read_len == 0 && ri >= n_read_cig; };
  auto is_match = [](int op) {
    return op == RM_M || op == RM_X || op == RM_EQ;
  };

  // find_start_pos (translate_cigar.cpp:267-300)
  int64_t cpos = 0;
  while (cpos < start && !eos()) {
    if (seq_len == 0) {
      seq_advance();
      continue;
    }
    if (is_match(seq_op) || seq_op == RM_I) {
      int64_t dist = start - cpos;
      if (seq_len > dist) {
        seq_len -= dist;
        cpos = start;
      } else {
        cpos += seq_len;
        seq_len = 0;
      }
    } else if (seq_op == RM_N || seq_op == RM_D) {
      seq_len = 0;
    } else {
      return false;
    }
  }
  if (cpos < start) return false;

  // remap op -> bwa cigar op (tr_seqop: X/= are NOT accepted, they throw)
  auto tr_seqop = [](int op, int* res) -> bool {
    switch (op) {
      case RM_M: *res = CIG_M; return true;
      case RM_I: *res = CIG_I; return true;
      case RM_D: *res = CIG_D; return true;
      case RM_N: *res = 4;     return true;  // FROM_N
      default:   return false;               // X/= -> error
    }
  };

  if (read_cig == nullptr) {
    int64_t ln = 0;
    while (ln < total_read_len && !eos()) {
      if (seq_len == 0) {
        seq_advance();
        continue;
      }
      int op;
      if (!tr_seqop(seq_op, &op)) return false;
      int64_t dist = total_read_len - ln;
      if (seq_len < dist) {
        cb.push(op, seq_len);
        ln += seq_len;
        seq_advance();
      } else {
        cb.push(op, dist);
        break;
      }
    }
    *out = std::move(cb.c);
    return true;
  }

  while (!eor() && !eos()) {
    if (seq_len == 0) seq_advance();
    if (read_len == 0) read_advance();
    if (read_op == CIG_S) {
      cb.push(read_op, read_len);
      read_len = 0;
      if (!eor()) read_advance();
      continue;
    }
    if (is_match(seq_op)) {  // in_match
      if (read_op == CIG_M || read_op == CIG_D || read_op == 4) {
        if (seq_len >= read_len) {
          cb.push(read_op, read_len);
          seq_len -= read_len;
          read_len = 0;
        } else {
          cb.push(read_op, seq_len);
          read_len -= seq_len;
          seq_len = 0;
        }
      } else if (read_op == CIG_I) {
        cb.push(read_op, read_len);
        read_len = 0;
      } else {
        return false;
      }
    } else if (seq_op == RM_I) {  // in_insertion
      if (read_op == CIG_M) {
        if (seq_len < read_len) {
          cb.push(CIG_I, seq_len);
          read_len -= seq_len;
          seq_len = 0;
        } else {
          cb.push(CIG_I, read_len);
          seq_len -= read_len;
          read_len = 0;
        }
      } else if (read_op == CIG_I) {
        cb.push(read_op, read_len);
        read_len = 0;
      } else if (read_op == CIG_D || read_op == 4) {
        if (seq_len > read_len) {
          seq_len -= read_len;
          read_len = 0;
        } else {
          read_len -= seq_len;
          seq_len = 0;
        }
      } else {
        return false;
      }
    } else if (seq_op == RM_N || seq_op == RM_D) {  // in_deletion
      int op;
      if (!tr_seqop(seq_op, &op)) return false;
      if (read_op == CIG_M) {
        cb.push(op, seq_len);
        seq_advance();
      } else if (read_op == CIG_I) {
        cb.push(op, seq_len);
        seq_advance();
        cb.push(read_op, read_len);
        read_advance();
      } else if (read_op == CIG_D || read_op == 4) {
        cb.push(op, seq_len);
        seq_len = 0;
      } else {
        return false;
      }
    } else {
      return false;
    }
  }
  while (!eor()) {
    if (read_len == 0) read_advance();
    if (read_op == CIG_M || read_op == CIG_I || read_op == CIG_S)
      cb.push(CIG_S, read_len);
    read_len = 0;
  }
  *out = std::move(cb.c);
  return true;
}

// refine_gapped_core (bwase.c:167-241): re-extract the reference around
// the hit, banded global DP, post-fix the cigar, translate through the
// remap cigar.  Returns the (possibly empty<->dropped) cigar + new pos.
struct EmitScratch {
  std::vector<uint8_t> ref;
  std::vector<uint32_t> cig;
  std::vector<uint8_t> md_ref;
  std::vector<char> md_buf;
};

static void refine_core(const PeCtx& ctx, int dbidx, int32_t seqid,
                        int64_t length, const uint8_t* seq, int64_t pos,
                        int64_t ext, int is_end_correct, EmitScratch& sc,
                        std::vector<uint32_t>* out_cig, bool* has_cig,
                        int64_t* out_pos) {
  if (pos > ctx.l_pac_total) {
    fprintf(stderr, "position=%lld > l_pac=%lld\n", (long long)pos,
            (long long)ctx.l_pac_total);
    exit(1);
  }
  int64_t ref_len = length + (ext > 0 ? ext : -ext);
  int64_t ref_start;
  if (ext > 0) {
    ref_start = pos;
  } else {
    int64_t x = pos + (is_end_correct ? length : ref_len);
    ref_start = (x - ref_len > 0) ? x - ref_len : 0;
    ref_len = x - ref_start;
  }
  extract_remapped(ctx, dbidx, seqid, ref_start, ref_len, &sc.ref);
  sc.cig.resize((size_t)(sc.ref.size() + length + 2));
  int32_t score = 0;
  int32_t n = ibwa_global_aln(sc.ref.data(), (int32_t)sc.ref.size(), seq,
                              (int32_t)length, kGapOpen, kGapExt, kGapEnd,
                              kBand, kSmMaq, 5, sc.cig.data(),
                              (int32_t)sc.cig.size(), &score);
  sc.cig.resize(n < 0 ? 0 : (size_t)n);
  std::vector<uint32_t>& cig = sc.cig;

  if (ext < 0 && is_end_correct) {  // fix fwd-strand coordinate
    int64_t l = 0;
    for (uint32_t c : cig) {
      if (cig_op(c) == CIG_D) l -= cig_len(c);
      else if (cig_op(c) == CIG_I) l += cig_len(c);
    }
    pos += l;
  }
  if (!cig.empty() && cig_op(cig.front()) == CIG_D) {  // 5'-end deletion
    pos += cig_len(cig.front());
    cig.erase(cig.begin());
  }
  if (!cig.empty() && cig_op(cig.back()) == CIG_D)  // 3'-end deletion
    cig.pop_back();
  if (!cig.empty() && cig_op(cig.back()) == CIG_I)  // I at ends -> S
    cig.back() = cig_make(CIG_S, cig_len(cig.back()));
  if (!cig.empty() && cig_op(cig.front()) == CIG_I)
    cig.front() = cig_make(CIG_S, cig_len(cig.front()));

  const PeDb& db = ctx.dbs[dbidx];
  *has_cig = true;
  if (db.has_remap && seqid >= 0 && seqid < db.n_remap &&
      db.rm_run_cnt[seqid] > 0) {
    int64_t start = pos - db.offset - db.ann_off[seqid];
    std::vector<uint32_t> tcig;
    if (translate_cigar_c(db, seqid, start, cig.data(), (int32_t)cig.size(),
                          length, &tcig)) {
      *out_cig = std::move(tcig);
    } else {
      fprintf(stderr, "Error translating cigar string\n");
      out_cig->clear();
      *has_cig = false;  // None in Python: record falls back to "{len}M"
    }
  } else {
    *out_cig = cig;
  }
  *out_pos = pos;
}

// per-end-read mutable emit state (cigar/md/multis live outside io arrays)
struct EmitMulti {
  int64_t pos;
  int32_t gap, mm, strand, dbidx;
  std::vector<uint32_t> cigar;
  bool has_cigar = false;
};

struct EmitSeq {
  std::vector<uint32_t> cigar;
  bool has_cigar = false;
  std::string md;
  bool has_md = false;
  int32_t nm = 0;
  int64_t cur_len;  // s.len (clip_len, then full_len after correct_trimmed)
  std::vector<EmitMulti> multis;
  std::vector<uint8_t> seq_fwd;  // forward-oriented clipped codes
};

// read-only per-end-read input views
struct EmitReadView {
  const uint8_t* seq;   // reversed clipped codes (r.seq)
  const uint8_t* rseq;  // revcomp clipped codes (r.rseq)
  const uint8_t* orig;  // forward full-length codes
  const uint8_t* qual;  // full_len bytes or nullptr
  const uint8_t* name;
  int64_t name_len;
  const uint8_t* bc;
  int64_t bc_len;
  int32_t clip_len, full_len;
};

// bwa_cal_md1 via the shared walk; one extraction for the whole span
static double g_md_extract_s = 0, g_md_walk_s = 0;
static double md_now() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + 1e-9 * ts.tv_nsec;
}
static void emit_cal_md(const PeCtx& ctx, EmitSeq& es, int64_t rpos,
                        const uint8_t* sseq, int64_t length,
                        EmitScratch& sc) {
  double md_t0 = md_now();
  int64_t need = 0;
  const uint32_t* cig = nullptr;
  int32_t ncig = 0;
  if (es.has_cigar && !es.cigar.empty()) {
    for (uint32_t c : es.cigar)
      if (cig_op(c) == CIG_M || cig_op(c) == CIG_D) need += cig_len(c);
    cig = es.cigar.data();
    ncig = (int32_t)es.cigar.size();
  } else {
    need = length;
  }
  int64_t span = std::min(need, std::max(ctx.l_pac_total - rpos, (int64_t)0));
  if (span > 0)
    extract_sequence(ctx, rpos, span, &sc.md_ref);
  else
    sc.md_ref.clear();
  double md_t1 = md_now();
  g_md_extract_s += md_t1 - md_t0;
  int64_t cap = 16 + 2 * need + 12 * (ncig + 1) + length;
  if ((int64_t)sc.md_buf.size() < cap) sc.md_buf.resize(cap);
  int32_t nm = 0;
  int64_t n = ibwa_cal_md(cig, ncig, sc.md_ref.data(),
                          (int64_t)sc.md_ref.size(), rpos, ctx.l_pac_total,
                          sseq, (int32_t)length, sc.md_buf.data(), cap, &nm);
  if (n < 0) {
    fprintf(stderr, "ibwa_cal_md: buffer overflow\n");
    exit(1);
  }
  es.md.assign(sc.md_buf.data(), (size_t)n);
  es.has_md = true;
  es.nm = nm;
  g_md_walk_s += md_now() - md_t1;
}

// bwa_correct_trimmed (bwase.c:297-331)
static void correct_trimmed(EmitSeq& es, int32_t strand, int32_t clip_len,
                            int32_t full_len) {
  if (es.cur_len == full_len) return;
  int64_t pad = full_len - es.cur_len;
  if (strand == 0) {
    if (es.has_cigar && !es.cigar.empty() &&
        cig_op(es.cigar.back()) == CIG_S) {
      es.cigar.back() += (uint32_t)pad;
    } else {
      if (!es.has_cigar) {
        es.cigar.assign(1, cig_make(CIG_M, es.cur_len));
        es.has_cigar = true;
      }
      es.cigar.push_back(cig_make(CIG_S, pad));
    }
  } else {
    if (es.has_cigar && !es.cigar.empty() &&
        cig_op(es.cigar.front()) == CIG_S) {
      es.cigar.front() += (uint32_t)pad;
    } else {
      if (!es.has_cigar) {
        es.cigar.assign(1, cig_make(CIG_M, es.cur_len));
        es.has_cigar = true;
      }
      es.cigar.insert(es.cigar.begin(), cig_make(CIG_S, pad));
    }
  }
  es.cur_len = full_len;
}

// bwa_refine_gapped (bwase.c:333-449) for one end-read, nucleotide space
static void refine_one(const PeCtx& ctx, Seq& s, EmitSeq& es,
                       const EmitReadView& rv, EmitScratch& sc) {
  int64_t remapped_gapo = 0;
  int dbidx = s.i32[G_DBIDX];
  const PeDb& db = ctx.dbs[dbidx];
  int32_t rseqid = s.i32[G_RSEQID];
  if (db.has_remap && rseqid >= 0 && rseqid < db.n_remap &&
      db.rm_ngapo != nullptr)
    remapped_gapo += db.rm_ngapo[rseqid];
  // seq_reverse(s->len, s->seq, 0): forward-oriented clipped codes
  es.seq_fwd.assign(rv.seq, rv.seq + rv.clip_len);
  std::reverse(es.seq_fwd.begin(), es.seq_fwd.end());
  for (EmitMulti& q : es.multis) {
    if (q.gap == 0) continue;
    const uint8_t* qseq = q.strand ? rv.rseq : es.seq_fwd.data();
    int64_t ext = (q.strand ? 1 : -1) * (int64_t)q.gap;
    // multis use q->remapped_seqid, which is calloc'd to 0 and never set
    // (bwt_multi1_t quirk, bwase.c:354) — NOT the primary's seqid
    refine_core(ctx, q.dbidx, 0, es.cur_len, qseq, q.pos, ext, 1, sc,
                &q.cigar, &q.has_cigar, &q.pos);
  }
  int32_t type = s.i32[G_TYPE];
  if (type == TYPE_NO_MATCH || type == TYPE_MATESW ||
      (s.i32[G_NGAPO] == 0 && remapped_gapo == 0))
    return;
  const uint8_t* sseq = s.i32[G_STRAND] ? rv.rseq : es.seq_fwd.data();
  int64_t ext = (s.i32[G_STRAND] ? 1 : -1) *
                (int64_t)(s.i32[G_NGAPO] + s.i32[G_NGAPE]);
  int64_t newpos = s.i64[F_POS];
  refine_core(ctx, dbidx, rseqid, es.cur_len, sseq, newpos, ext, 1, sc,
              &es.cigar, &es.has_cigar, &newpos);
  s.i64[F_POS] = newpos;
}

// ---- SAM text assembly (bwa_print_sam1, bwase.c:451-581) ----

static const char kBaseCh[] = "ACGTN";
static const char kCompCh[] = "TGCAN";

struct SamOut {
  std::string& s;
  void ch(char c) { s.push_back(c); }
  void str(const char* p, size_t n) { s.append(p, n); }
  void cstr(const char* p) { s.append(p); }
  void num(int64_t v) {
    char tmp[24];
    int n = snprintf(tmp, sizeof(tmp), "%lld", (long long)v);
    s.append(tmp, n);
  }
};

static void put_cigar(SamOut& o, const std::vector<uint32_t>& cig) {
  static const char ops[] = "MIDSN";
  for (uint32_t c : cig) {
    o.num(cig_len(c));
    o.ch(ops[cig_op(c)]);
  }
}

static int64_t pos_end_es(const Seq& s, const EmitSeq& es) {
  if (es.has_cigar && !es.cigar.empty()) {
    int64_t x = s.i64[F_POS];
    for (uint32_t c : es.cigar)
      if (cig_op(c) == CIG_M || cig_op(c) == CIG_D) x += cig_len(c);
    return x;
  }
  return s.i64[F_POS] + es.cur_len;
}

static int64_t pos_end_multi_es(const EmitMulti& q, int64_t length) {
  if (q.has_cigar && !q.cigar.empty()) {
    int64_t x = q.pos;
    for (uint32_t c : q.cigar)
      if (cig_op(c) == CIG_M || cig_op(c) == CIG_D) x += cig_len(c);
    return x;
  }
  return q.pos + length;
}

static int64_t pos_5_es(const Seq& s, const EmitSeq& es) {
  if (s.i32[G_TYPE] != TYPE_NO_MATCH)
    return s.i32[G_STRAND] ? pos_end_es(s, es) : s.i64[F_POS];
  return -1;
}

static const uint8_t* db_ctg_name(const PeDb& db, int32_t seqid,
                                  int64_t* len) {
  *len = db.name_off[seqid + 1] - db.name_off[seqid];
  return db.names + db.name_off[seqid];
}

struct EmitOpts {
  int32_t mode;
  int32_t max_top2;
  std::string rg_id;  // empty = none
};

static void print_sam1(const PeCtx& ctx, const EmitOpts& eo, Seq* p,
                       EmitSeq* pes, const EmitReadView& rv, Seq* mate,
                       EmitSeq* mes, SamOut& o) {
  int32_t ptype = p->i32[G_TYPE];
  int32_t mtype = mate ? mate->i32[G_TYPE] : TYPE_NO_MATCH;
  if (ptype != TYPE_NO_MATCH || (mate && mtype != TYPE_NO_MATCH)) {
    int64_t am = 0;
    int64_t flag = p->i32[G_XFLAG];
    int64_t j;
    if (ptype == TYPE_NO_MATCH) {
      p->i64[F_POS] = mate->i64[F_POS];
      p->i64[F_RPOS] = mate->i64[F_RPOS];
      p->i32[G_STRAND] = mate->i32[G_STRAND];
      flag |= SAM_FSU;
      j = 1;
    } else {
      j = pos_end_es(*p, *pes) - p->i64[F_POS];
    }
    int64_t nn;
    int32_t seqid, dbx;
    coor_pac2real(ctx, p->i64[F_POS], j, &nn, &seqid, &dbx);
    const PeDb& db = ctx.dbs[dbx];
    if (ptype != TYPE_NO_MATCH &&
        p->i64[F_POS] + j - (db.ann_off[seqid] + db.offset) >
            (int64_t)db.ann_len[seqid])
      flag |= SAM_FSU;  // bridges two adjacent reference sequences
    if (p->i32[G_STRAND]) flag |= SAM_FSR;
    if (mate) {
      if (mtype != TYPE_NO_MATCH) {
        if (mate->i32[G_STRAND]) flag |= SAM_FMR;
      } else {
        flag |= SAM_FMU;
      }
    }
    o.str((const char*)rv.name, rv.name_len);
    o.ch('\t');
    o.num(flag);
    o.ch('\t');
    int64_t nl;
    const uint8_t* nm = db_ctg_name(db, seqid, &nl);
    o.str((const char*)nm, nl);
    o.ch('\t');
    o.num(p->i64[F_POS] - (db.ann_off[seqid] + db.offset) + 1);
    o.ch('\t');
    o.num(p->i32[G_MAPQ]);
    o.ch('\t');
    if (pes->has_cigar && !pes->cigar.empty()) {
      put_cigar(o, pes->cigar);
    } else if (ptype == TYPE_NO_MATCH) {
      o.ch('*');
    } else {
      o.num(pes->cur_len);
      o.ch('M');
    }
    if (mate && mtype != TYPE_NO_MATCH) {
      am = std::min(mate->i32[G_SEQ], p->i32[G_SEQ]);
      int64_t m_nn;
      int32_t m_seqid, m_dbx;
      coor_pac2real(ctx, mate->i64[F_POS], mes->cur_len, &m_nn, &m_seqid,
                    &m_dbx);
      const PeDb& mdb = ctx.dbs[m_dbx];
      bool same = (seqid == m_seqid && db.offset == mdb.offset);
      o.ch('\t');
      if (same) {
        o.ch('=');
      } else {
        int64_t mnl;
        const uint8_t* mn = db_ctg_name(mdb, m_seqid, &mnl);
        o.str((const char*)mn, mnl);
      }
      o.ch('\t');
      int64_t isize = same ? pos_5_es(*mate, *mes) - pos_5_es(*p, *pes) : 0;
      if (ptype == TYPE_NO_MATCH) isize = 0;
      o.num(mate->i64[F_POS] - (mdb.ann_off[m_seqid] + mdb.offset) + 1);
      o.ch('\t');
      o.num(isize);
      o.ch('\t');
    } else if (mate) {
      o.cstr("\t=\t");
      o.num(p->i64[F_POS] - (db.ann_off[seqid] + db.offset) + 1);
      o.cstr("\t0\t");
    } else {
      o.cstr("\t*\t0\t0\t");
    }

    // sequence + quality (original read orientation rules)
    if (p->i32[G_STRAND] == 0) {
      for (int32_t i = 0; i < rv.full_len; ++i)
        o.ch(kBaseCh[rv.orig[i] > 4 ? 4 : rv.orig[i]]);
    } else {
      for (int32_t i = rv.full_len - 1; i >= 0; --i)
        o.ch(kCompCh[rv.orig[i] > 4 ? 4 : rv.orig[i]]);
    }
    o.ch('\t');
    if (rv.qual) {
      int64_t cl = std::min<int64_t>(pes->cur_len, rv.full_len);
      if (p->i32[G_STRAND]) {
        for (int64_t i = cl - 1; i >= 0; --i) o.ch((char)rv.qual[i]);
        for (int64_t i = cl; i < rv.full_len; ++i) o.ch((char)rv.qual[i]);
      } else {
        o.str((const char*)rv.qual, rv.full_len);
      }
    } else {
      o.ch('*');
    }

    if (!eo.rg_id.empty()) {
      o.cstr("\tRG:Z:");
      o.str(eo.rg_id.data(), eo.rg_id.size());
    }
    if (rv.bc_len) {
      o.cstr("\tBC:Z:");
      o.str((const char*)rv.bc, rv.bc_len);
    }
    if (rv.clip_len < rv.full_len) {
      o.cstr("\tXC:i:");
      o.num(rv.clip_len);
    }
    if (ptype != TYPE_NO_MATCH) {
      char XT = "NURM"[ptype];
      if (nn > 10) XT = 'N';
      o.cstr("\tXT:A:");
      o.ch(XT);
      o.ch('\t');
      o.cstr((eo.mode & 0x02) ? "NM" : "CM");  // BWA_MODE_COMPREAD
      o.cstr(":i:");
      o.num(pes->nm);
      if (nn) {
        o.cstr("\tXN:i:");
        o.num(nn);
      }
      if (mate) {
        o.cstr("\tSM:i:");
        o.num(p->i32[G_SEQ]);
        o.cstr("\tAM:i:");
        o.num(am);
      }
      if (ptype != TYPE_MATESW) {
        o.cstr("\tX0:i:");
        o.num(p->i64[F_C1]);
        if (p->i64[F_C1] <= eo.max_top2) {
          o.cstr("\tX1:i:");
          o.num(p->i64[F_C2]);
        }
      }
      o.cstr("\tXM:i:");
      o.num(p->i32[G_NMM]);
      o.cstr("\tXO:i:");
      o.num(p->i32[G_NGAPO]);
      o.cstr("\tXG:i:");
      o.num(p->i32[G_NGAPO] + p->i32[G_NGAPE]);
      if (pes->has_md) {
        o.cstr("\tMD:Z:");
        o.str(pes->md.data(), pes->md.size());
      }
      if (!pes->multis.empty()) {
        o.cstr("\tXA:Z:");
        for (const EmitMulti& q : pes->multis) {
          // the reference REBINDS the local j here (bwase.c:528), so the
          // ZR block below sees the last multi's span — keep that quirk
          j = pos_end_multi_es(q, pes->cur_len) - q.pos;
          int64_t q_nn;
          int32_t q_seqid, q_dbx;
          coor_pac2real(ctx, q.pos, j, &q_nn, &q_seqid, &q_dbx);
          const PeDb& qdb = ctx.dbs[q_dbx];
          int64_t qnl;
          const uint8_t* qn = db_ctg_name(qdb, q_seqid, &qnl);
          o.str((const char*)qn, qnl);
          o.ch(',');
          o.ch(q.strand ? '-' : '+');
          o.num(q.pos - (qdb.ann_off[q_seqid] + qdb.offset) + 1);
          o.ch(',');
          if (q.has_cigar && !q.cigar.empty()) {
            put_cigar(o, q.cigar);
          } else {
            o.num(pes->cur_len);
            o.ch('M');
          }
          o.ch(',');
          o.num(q.gap + q.mm);
          o.ch(';');
        }
      }
    }
    if (p->i64[F_POS] != p->i64[F_RPOS]) {
      int64_t r_nn;
      int32_t r_seqid, r_dbx;
      coor_pac2real(ctx, p->i64[F_RPOS], j, &r_nn, &r_seqid, &r_dbx);
      const PeDb& rdb = ctx.dbs[r_dbx];
      int64_t rnl;
      const uint8_t* rn = db_ctg_name(rdb, r_seqid, &rnl);
      o.cstr("\tZR:Z:");
      o.str((const char*)rn, rnl);
      o.ch(',');
      o.num(p->i64[F_RPOS] - (rdb.ann_off[r_seqid] + rdb.offset) + 1);
    }
    o.ch('\n');
  } else {  // no match (bwase.c:566-581)
    int64_t flag = p->i32[G_XFLAG] | SAM_FSU;
    if (mate && mtype == TYPE_NO_MATCH) flag |= SAM_FMU;
    o.str((const char*)rv.name, rv.name_len);
    o.ch('\t');
    o.num(flag);
    o.cstr("\t*\t0\t0\t*\t*\t0\t0\t");
    const uint8_t* s = p->i32[G_STRAND] ? rv.rseq : rv.orig;
    int64_t avail = p->i32[G_STRAND] ? rv.clip_len : rv.full_len;
    int64_t n = std::min<int64_t>(pes->cur_len, avail);
    for (int64_t i = 0; i < n; ++i) o.ch(kBaseCh[s[i] > 4 ? 4 : s[i]]);
    o.ch('\t');
    if (rv.qual) {
      int64_t cl = std::min<int64_t>(pes->cur_len, rv.full_len);
      if (p->i32[G_STRAND]) {
        for (int64_t i = cl - 1; i >= 0; --i) o.ch((char)rv.qual[i]);
        for (int64_t i = cl; i < rv.full_len; ++i) o.ch((char)rv.qual[i]);
      } else {
        o.str((const char*)rv.qual, rv.full_len);
      }
    } else {
      o.ch('*');
    }
    if (!eo.rg_id.empty()) {
      o.cstr("\tRG:Z:");
      o.str(eo.rg_id.data(), eo.rg_id.size());
    }
    if (rv.bc_len) {
      o.cstr("\tBC:Z:");
      o.str((const char*)rv.bc, rv.bc_len);
    }
    if (rv.clip_len < rv.full_len) {
      o.cstr("\tXC:i:");
      o.num(rv.clip_len);
    }
    o.ch('\n');
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

void* ibwa_pe_new(int32_t remapping, int32_t s_mm) {
  init_g_log_n();
  PeCtx* ctx = new PeCtx();
  ctx->remapping = remapping;
  ctx->s_mm = s_mm;
  return ctx;
}

void ibwa_pe_free(void* p) { delete (PeCtx*)p; }

void ibwa_pe_add_db(
    void* pctx, const uint32_t* itl_fwd, uint32_t primary_fwd,
    const uint32_t* itl_rev, uint32_t primary_rev, const uint32_t* l2,
    uint32_t seq_len, uint32_t sa_intv, const uint32_t* sa_fwd,
    const uint32_t* sa_rev, int64_t offset, int64_t l_pac, int32_t n_seqs,
    const int64_t* ann_off, const int32_t* ann_len, int32_t has_remap,
    int32_t n_remap, const int32_t* rm_target, const uint8_t* rm_exact,
    const int64_t* rm_start, const int64_t* rm_stop,
    const int64_t* rm_run_begin, const int32_t* rm_run_cnt,
    const uint8_t* rm_ops, const int32_t* rm_lens) {
  PeCtx* ctx = (PeCtx*)pctx;
  PeDb db;
  db.fwd.bwt = InterleavedBwt{itl_fwd, primary_fwd,
                              {l2[0], l2[1], l2[2], l2[3], l2[4]}, seq_len};
  db.rev.bwt = InterleavedBwt{itl_rev, primary_rev,
                              {l2[0], l2[1], l2[2], l2[3], l2[4]}, seq_len};
  db.fwd.sa_intv = db.rev.sa_intv = sa_intv;
  uint32_t shift = 0;
  if (sa_intv && (sa_intv & (sa_intv - 1)) == 0)
    shift = (uint32_t)__builtin_ctz(sa_intv);
  db.fwd.intv_shift = db.rev.intv_shift = shift;
  db.fwd.sampled_sa = sa_fwd;
  db.rev.sampled_sa = sa_rev;
  db.seq_len = seq_len;
  db.offset = offset;
  db.l_pac = l_pac;
  db.n_seqs = n_seqs;
  db.ann_off = ann_off;
  db.ann_len = ann_len;
  db.has_remap = has_remap != 0;
  db.n_remap = n_remap;
  db.rm_target = rm_target;
  db.rm_exact = rm_exact;
  db.rm_start = rm_start;
  db.rm_stop = rm_stop;
  db.rm_run_begin = rm_run_begin;
  db.rm_run_cnt = rm_run_cnt;
  db.rm_ops = rm_ops;
  db.rm_lens = rm_lens;
  ctx->dbs.push_back(db);
  ctx->n_db = (int)ctx->dbs.size();
}

// register one end's one db's .sai batch (counts + records for n reads)
void ibwa_pe_set_sai(void* pctx, int32_t end, int32_t dbidx,
                     const int32_t* counts, const uint32_t* recs,
                     int64_t n_reads) {
  PeCtx* ctx = (PeCtx*)pctx;
  SaiBatch& sb = ctx->sai[end][dbidx];
  sb.counts = counts;
  sb.recs = recs;
  sb.read_off.resize(n_reads);
  int64_t off = 0;
  for (int64_t i = 0; i < n_reads; ++i) {
    sb.read_off[i] = off;
    off += counts[i];
  }
}

// SE stage (bwa_cal_pac_pos_pe's serial selection loop, bwape.c:394-409):
// for each read, end 0 then end 1, build the group and select the primary.
// io_i64/io_i32 are the per-end-read field blocks (read-major, end inner).
void ibwa_pe_se_stage(void* pctx, int64_t n_reads, const int32_t* lens,
                      const int32_t* full_lens, const int32_t* max_diff,
                      uint64_t* rng_state, int64_t* io_i64, int32_t* io_i32) {
  PeCtx* ctx = (PeCtx*)pctx;
  Rng rng{*rng_state};
  std::vector<AlnRec> ag;
  for (int64_t i = 0; i < n_reads; ++i) {
    for (int j = 0; j < 2; ++j) {
      int64_t e = i * 2 + j;
      build_group(*ctx, j, i, &ag);
      Seq s{io_i64 + e * NF64, io_i32 + e * NF32, lens[e], full_lens[e],
            max_diff[e]};
      select_sai_ibwa(*ctx, ag, s, rng);
    }
  }
  *rng_state = rng.x;
}

// PE stage (bwa_cal_pac_pos_pe_thread, bwape.c:238-297): coordinate
// expansion, SE mapQ, pairing, and XA multi selection.  Returns cnt_chg.
int64_t ibwa_pe_pe_stage(void* pctx, int64_t n_reads, const int32_t* lens,
                         const int32_t* full_lens, const int32_t* max_diff,
                         double ii_avg, double ii_std, int64_t ii_low,
                         int64_t ii_high, int64_t ii_high_bayesian,
                         int64_t max_isize, int32_t n_multi, int32_t N_multi,
                         uint64_t* rng_state, int64_t* io_i64,
                         int32_t* io_i32, int32_t multi_cap,
                         int32_t* out_multi_cnt, int64_t* out_multi_pos,
                         int32_t* out_multi_meta) {
  PeCtx* ctx = (PeCtx*)pctx;
  Rng rng{*rng_state};
  IsizeC ii{ii_avg, ii_std, 0.0, ii_low, ii_high, ii_high_bayesian};
  PairOptC opt{max_isize, n_multi, N_multi, ctx->s_mm};
  int64_t cnt_chg = 0;
  std::vector<AlnRec> aln[2];
  std::vector<Position> arr;
  for (int64_t i = 0; i < n_reads; ++i) {
    int64_t e0 = i * 2, e1 = i * 2 + 1;
    build_group(*ctx, 0, i, &aln[0]);
    build_group(*ctx, 1, i, &aln[1]);
    Seq p[2] = {
        {io_i64 + e0 * NF64, io_i32 + e0 * NF32, lens[e0], full_lens[e0],
         max_diff[e0]},
        {io_i64 + e1 * NF64, io_i32 + e1 * NF32, lens[e1], full_lens[e1],
         max_diff[e1]},
    };
    compute_coords(*ctx, aln, p, &arr);
    for (int j = 0; j < 2; ++j) {
      if (p[j].i64[F_C1] || p[j].i64[F_C2]) {
        int q = approx_mapQ(p[j], p[j].max_diff);
        p[j].i32[G_SEQ] = p[j].i32[G_MAPQ] = q;
      }
    }
    int t0 = p[0].i32[G_TYPE], t1 = p[1].i32[G_TYPE];
    if ((t0 == TYPE_UNIQUE || t0 == TYPE_REPEAT) &&
        (t1 == TYPE_UNIQUE || t1 == TYPE_REPEAT)) {
      cnt_chg += find_optimal_pair(*ctx, p, arr, aln, opt, ii);
    }
    if (N_multi || n_multi) {
      for (int j = 0; j < 2; ++j) {
        int64_t e = i * 2 + j;
        out_multi_cnt[e] = 0;
        if (p[j].i32[G_TYPE] != TYPE_NO_MATCH) {
          int64_t max_multi = n_multi;
          if (!(p[j].i32[G_XFLAG] & SAM_FPP) &&
              p[1 - j].i32[G_TYPE] != TYPE_NO_MATCH) {
            max_multi =
                (p[j].i64[F_C1] + p[j].i64[F_C2] - 1 > N_multi) ? n_multi
                                                                : N_multi;
          }
          select_sai_multi(*ctx, aln[j], p[j], max_multi, rng,
                           out_multi_pos + e * multi_cap,
                           out_multi_meta + e * multi_cap * 4,
                           out_multi_cnt + e, multi_cap);
        }
      }
    }
  }
  *rng_state = rng.x;
  return cnt_chg;
}

// samse selection (bwa_aln2seq_core, bwase.c:29-104): weighted-random
// primary pick + multi-hit enumeration over ONE db's groups (end 0).
// Field layout matches ibwa_pe_se_stage's; multi entries carry the SA
// INDEX in pos (resolved later by the batched cal_pac_pos).
void ibwa_se_stage(void* pctx, int64_t n_reads, int32_t n_occ,
                   uint64_t* rng_state, int64_t* io_i64, int32_t* io_i32,
                   int32_t multi_cap, int32_t* out_multi_cnt,
                   int64_t* out_multi_pos, int32_t* out_multi_meta) {
  PeCtx* ctx = (PeCtx*)pctx;
  Rng rng{*rng_state};
  std::vector<AlnRec> ag;
  for (int64_t i = 0; i < n_reads; ++i) {
    build_group(*ctx, 0, i, &ag);
    int64_t* f64 = io_i64 + i * NF64;
    int32_t* f32 = io_i32 + i * NF32;
    out_multi_cnt[i] = 0;
    if (ag.empty()) {
      f32[G_TYPE] = TYPE_NO_MATCH;
      f64[F_C1] = f64[F_C2] = 0;
      continue;
    }
    // set_main (bwase.c:36-61)
    int32_t best = ag[0].score;
    int64_t cnt = 0;
    size_t i2 = 0;
    while (i2 < ag.size()) {
      const AlnRec& p = ag[i2];
      if (p.score > best) break;
      int64_t naln = (int64_t)p.l - (int64_t)p.k + 1;
      if (rng.next() * (double)(naln + cnt) > (double)cnt) {
        f32[G_NMM] = p.n_mm;
        f32[G_NGAPO] = p.n_gapo;
        f32[G_NGAPE] = p.n_gape;
        f32[G_STRAND] = p.a;
        f32[G_SCORE] = p.score;
        f64[F_SA] = (int64_t)p.k + (int64_t)(naln * rng.next());
      }
      cnt += naln;
      ++i2;
    }
    f64[F_C1] = cnt;
    for (size_t t = i2; t < ag.size(); ++t)
      cnt += (int64_t)ag[t].l - (int64_t)ag[t].k + 1;
    f64[F_C2] = cnt - f64[F_C1];
    f32[G_TYPE] = f64[F_C1] > 1 ? TYPE_REPEAT : TYPE_UNIQUE;

    // multi enumeration (bwase.c:63-104)
    if (n_occ) {
      int64_t total = 0;
      for (const AlnRec& q : ag) total += (int64_t)q.l - (int64_t)q.k + 1;
      if (total > n_occ + 1) continue;  // too many hits: none
      int64_t rest = total;
      int64_t w = 0;
      bool done = false;
      for (const AlnRec& q : ag) {
        if (done) break;
        int64_t width = (int64_t)q.l - (int64_t)q.k + 1;
        if (width <= rest) {
          for (int64_t s = (int64_t)q.k; s <= (int64_t)q.l; ++s) {
            if (s == f64[F_SA]) continue;  // filtered below in Python? no:
            // NOTE: the Python filters z by pos != s.sa AFTER building;
            // order is preserved by filtering inline here
            if (w < multi_cap && w < n_occ) {
              out_multi_pos[i * multi_cap + w] = s;
              int32_t* m = out_multi_meta + (i * multi_cap + w) * 4;
              m[0] = q.n_gapo + q.n_gape;
              m[1] = q.n_mm;
              m[2] = q.a;
              m[3] = 0;
              ++w;
            }
          }
          rest -= width;
        } else {  // "we never come here"
          int64_t j = rest;
          int64_t ii = width;
          while (j > 0) {
            double pp = 1.0;
            double x = rng.next();
            while (x < pp) {
              pp -= pp * (double)j / (double)ii;
              --ii;
            }
            int64_t s = (int64_t)q.l - ii;
            if (s != f64[F_SA] && w < multi_cap && w < n_occ) {
              out_multi_pos[i * multi_cap + w] = s;
              int32_t* m = out_multi_meta + (i * multi_cap + w) * 4;
              m[0] = q.n_gapo + q.n_gape;
              m[1] = q.n_mm;
              m[2] = q.a;
              m[3] = 0;
              ++w;
            }
            --j;
          }
          done = true;
        }
      }
      out_multi_cnt[i] = (int32_t)w;
    }
  }
  *rng_state = rng.x;
}

// Emit-time per-db data: packed pac bytes, .amb hole list, contig names
// (concatenated, name_off has n_seqs+1 entries) and per-remap-record gap
// opens.  Must be called once per db before ibwa_pe_emit.
void ibwa_pe_set_emit_db(void* pctx, int32_t dbidx, const uint8_t* pac,
                         int64_t n_holes, const int64_t* amb_off,
                         const int32_t* amb_len, const uint8_t* names,
                         const int64_t* name_off, const int32_t* rm_ngapo) {
  PeCtx* ctx = (PeCtx*)pctx;
  PeDb& db = ctx->dbs[dbidx];
  db.pac = pac;
  db.n_holes = n_holes;
  db.amb_off = amb_off;
  db.amb_len = amb_len;
  db.names = names;
  db.name_off = name_off;
  db.rm_ngapo = rm_ngapo;
  ctx->l_pac_total = 0;
  for (const PeDb& d : ctx->dbs) ctx->l_pac_total += d.l_pac;
}

// The batch emit stage.  For SE (is_pe=0, se_mode=1): resolves SA indexes
// (primary + multis) to positions, computes mapQ, refines, computes MD,
// corrects trimming and prints one record per read (bwa_sai2sam_se_core
// batch body, bwase.c:643-708).  For PE (is_pe=1): takes the post-pairing
// + post-rescue state, refines both ends, re-remaps, swaps pos<->rpos
// under -R, and prints both records per pair (bwape.c:476-537).
// Blob arrays are indexed per end-read e (SE: e = unit; PE: e = 2*unit+j)
// via *_off offset arrays of n_er+1 entries.  Returns the SAM text length
// (fetch via ibwa_pe_emit_buf) or -1 on error.
int64_t ibwa_pe_emit(
    void* pctx, int32_t is_pe, int32_t se_mode, int64_t n_units,
    const uint8_t* orig_blob, const int64_t* orig_off,
    const uint8_t* qual_blob, const int64_t* qual_off,
    const uint8_t* name_blob, const int64_t* name_off, const uint8_t* bc_blob,
    const int64_t* bc_off, const int32_t* clip_len, const int32_t* full_len,
    const int32_t* max_diff, int64_t* io_i64, int32_t* io_i32,
    const int32_t* multi_cnt, const int64_t* multi_pos,
    const int32_t* multi_meta, int32_t multi_cap, const uint32_t* in_cig,
    const int64_t* in_cig_off, const int32_t* in_cig_cnt, int32_t mode,
    int32_t max_top2, const char* rg_id) {
  PeCtx* ctx = (PeCtx*)pctx;
  init_g_log_n();
  int64_t n_er = n_units * (is_pe ? 2 : 1);
  EmitOpts eo{mode, max_top2, rg_id ? std::string(rg_id) : std::string()};

  std::vector<EmitSeq> ess(n_er);
  std::vector<EmitReadView> rvs(n_er);
  std::vector<Seq> sqs(n_er);
  // seq (reversed clipped) + rseq (revcomp clipped) arenas derived from
  // the forward codes — the Python side ships only the parsed fastq blob
  int64_t clip_tot = 0;
  for (int64_t e = 0; e < n_er; ++e) clip_tot += clip_len[e];
  std::vector<uint8_t> seq_arena((size_t)clip_tot);
  std::vector<uint8_t> rseq_arena((size_t)clip_tot);
  std::vector<int64_t> seq_off((size_t)n_er + 1);
  seq_off[0] = 0;
  for (int64_t e = 0; e < n_er; ++e) {
    seq_off[e + 1] = seq_off[e] + clip_len[e];
    const uint8_t* o = orig_blob + orig_off[e];
    uint8_t* sd = seq_arena.data() + seq_off[e];
    uint8_t* rd = rseq_arena.data() + seq_off[e];
    int32_t cl = clip_len[e];
    for (int32_t j = 0; j < cl; ++j) {
      uint8_t c = o[cl - 1 - j];
      sd[j] = c;
      rd[j] = c < 4 ? (uint8_t)(3 - c) : c;
    }
  }
  for (int64_t e = 0; e < n_er; ++e) {
    EmitReadView& rv = rvs[e];
    rv.seq = seq_arena.data() + seq_off[e];
    rv.rseq = rseq_arena.data() + seq_off[e];
    rv.orig = orig_blob + orig_off[e];
    rv.qual = (qual_off[e + 1] - qual_off[e] == full_len[e])
                  ? qual_blob + qual_off[e]
                  : nullptr;
    rv.name = name_blob + name_off[e];
    rv.name_len = name_off[e + 1] - name_off[e];
    rv.bc = bc_blob + bc_off[e];
    rv.bc_len = bc_off[e + 1] - bc_off[e];
    rv.clip_len = clip_len[e];
    rv.full_len = full_len[e];
    EmitSeq& es = ess[e];
    es.cur_len = clip_len[e];
    sqs[e] = Seq{io_i64 + e * NF64, io_i32 + e * NF32, clip_len[e],
                 full_len[e], max_diff[e]};
    int32_t mc = multi_cnt ? multi_cnt[e] : 0;
    es.multis.resize(mc);
    for (int32_t t = 0; t < mc; ++t) {
      int64_t b = e * multi_cap + t;
      EmitMulti& q = es.multis[t];
      q.pos = multi_pos[b];
      q.gap = multi_meta[b * 4 + 0];
      q.mm = multi_meta[b * 4 + 1];
      q.strand = multi_meta[b * 4 + 2];
      q.dbidx = multi_meta[b * 4 + 3];
    }
    if (in_cig_cnt && in_cig_cnt[e] > 0) {  // mate-rescue cigar (paired_sw)
      es.cigar.assign(in_cig + in_cig_off[e],
                      in_cig + in_cig_off[e] + in_cig_cnt[e]);
      es.has_cigar = true;
    }
  }

  if (se_mode) {  // bwa_cal_pac_pos (bwase.c:137-161): single-db SA walks
    const PeDb& db0 = ctx->dbs[0];
    for (int64_t e = 0; e < n_er; ++e) {
      Seq& s = sqs[e];
      int32_t type = s.i32[G_TYPE];
      for (EmitMulti& q : ess[e].multis)
        q.pos = sa2seq(db0, q.strand, (uint32_t)q.pos, s.len);
      if (type == TYPE_UNIQUE || type == TYPE_REPEAT) {
        s.i64[F_POS] =
            sa2seq(db0, s.i32[G_STRAND], (uint32_t)s.i64[F_SA], s.len);
        int q = approx_mapQ(s, s.max_diff);
        s.i32[G_SEQ] = s.i32[G_MAPQ] = q;
      }
    }
  }

  // refine + MD + trimming correction, end-major like the Python driver
  static const bool kTime = getenv("IBWA_EMIT_TIME") != nullptr;
  auto now = [] {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec + 1e-9 * ts.tv_nsec;
  };
  double t0 = kTime ? now() : 0.0, t_sa = 0, t_ref = 0, t_md = 0, t_pr = 0;
  if (kTime) { t_sa = now(); }
  EmitScratch sc;
  int ends = is_pe ? 2 : 1;
  for (int j = 0; j < ends; ++j) {
    for (int64_t u = 0; u < n_units; ++u) {
      int64_t e = is_pe ? u * 2 + j : u;
      refine_one(*ctx, sqs[e], ess[e], rvs[e], sc);
    }
    if (kTime) { t_ref = now(); }
    for (int64_t u = 0; u < n_units; ++u) {  // MD pass (bwase.c:390-405)
      int64_t e = is_pe ? u * 2 + j : u;
      Seq& s = sqs[e];
      if (s.i32[G_TYPE] != TYPE_NO_MATCH) {
        EmitSeq& es = ess[e];
        const uint8_t* sseq =
            s.i32[G_STRAND] ? rvs[e].rseq : es.seq_fwd.data();
        if (es.seq_fwd.empty() && !s.i32[G_STRAND]) {
          es.seq_fwd.assign(rvs[e].seq, rvs[e].seq + rvs[e].clip_len);
          std::reverse(es.seq_fwd.begin(), es.seq_fwd.end());
          sseq = es.seq_fwd.data();
        }
        emit_cal_md(*ctx, es, s.i64[F_RPOS], sseq, es.cur_len, sc);
      }
    }
    for (int64_t u = 0; u < n_units; ++u) {  // bwa_correct_trimmed
      int64_t e = is_pe ? u * 2 + j : u;
      correct_trimmed(ess[e], sqs[e].i32[G_STRAND], clip_len[e],
                      full_len[e]);
    }
  }

  if (is_pe) {  // post-refine re-remap (bwape.c:493-505)
    for (int j = 0; j < 2; ++j) {
      for (int64_t u = 0; u < n_units; ++u) {
        int64_t e = u * 2 + j;
        Seq& s = sqs[e];
        RemapIO rio;
        rio.pos = s.i64[F_POS];
        rio.n_gapo = s.i32[G_NGAPO];
        rio.n_gape = s.i32[G_NGAPE];
        rio.len = ess[e].cur_len;
        int status = do_remap(*ctx, &rio, s.i32[G_DBIDX]);
        s.i32[G_DBIDX] = rio.dbidx;
        s.i64[F_RPOS] = rio.remapped_pos;
        s.i32[G_RSEQID] = rio.remapped_seqid;
        s.i32[G_RIDENT] = rio.remap_identical;
        if (status == 0) {  // always unmaps when -R is off (ref quirk)
          fprintf(stderr, "Failed to remap read %.*s after refining gaps.\n",
                  (int)rvs[e].name_len, (const char*)rvs[e].name);
          unmap_read(s);
          ess[e].has_cigar = false;
          ess[e].cigar.clear();
        }
      }
    }
  }

  if (kTime) { t_md = now(); }
  std::string& out = ctx->emit_buf;
  out.clear();
  out.reserve((size_t)n_er * 256);
  SamOut o{out};
  if (is_pe) {
    std::string bc_merge;
    for (int64_t u = 0; u < n_units; ++u) {
      int64_t e0 = u * 2, e1 = u * 2 + 1;
      // barcode merge (bwape.c:509-516)
      EmitReadView& r0 = rvs[e0];
      EmitReadView& r1 = rvs[e1];
      if (r0.bc_len || r1.bc_len) {
        bc_merge.assign((const char*)r0.bc, r0.bc_len);
        bc_merge.append((const char*)r1.bc, r1.bc_len);
        r0.bc = r1.bc = (const uint8_t*)bc_merge.data();
        r0.bc_len = r1.bc_len = (int64_t)bc_merge.size();
      }
      if (ctx->remapping) {  // swap so SAM uses primary coords
        std::swap(sqs[e0].i64[F_POS], sqs[e0].i64[F_RPOS]);
        std::swap(sqs[e1].i64[F_POS], sqs[e1].i64[F_RPOS]);
      } else {
        sqs[e0].i64[F_RPOS] = sqs[e0].i64[F_POS];
        sqs[e1].i64[F_RPOS] = sqs[e1].i64[F_POS];
      }
      print_sam1(*ctx, eo, &sqs[e0], &ess[e0], rvs[e0], &sqs[e1], &ess[e1],
                 o);
      print_sam1(*ctx, eo, &sqs[e1], &ess[e1], rvs[e1], &sqs[e0], &ess[e0],
                 o);
    }
  } else {
    for (int64_t e = 0; e < n_er; ++e)
      print_sam1(*ctx, eo, &sqs[e], &ess[e], rvs[e], nullptr, nullptr, o);
  }
  if (kTime) {
    t_pr = now();
    fprintf(stderr,
            "[emit] refine %.1fms md+trim %.1fms (extract %.1f walk %.1f) "
            "print %.1fms\n",
            1e3 * (t_ref - t0), 1e3 * (t_md - t_ref), 1e3 * g_md_extract_s,
            1e3 * g_md_walk_s, 1e3 * (t_pr - t_md));
    g_md_extract_s = g_md_walk_s = 0;
  }
  return (int64_t)out.size();
}

const char* ibwa_pe_emit_buf(void* pctx) {
  return ((PeCtx*)pctx)->emit_buf.data();
}

// .sai batch scan: parse up to n_reads records from blob; writes per-read
// counts and compacts all bwt_aln1_t records (16B each) into recs_out.
// Returns bytes consumed, or -1 if the blob ends mid-read.
int64_t ibwa_sai_scan(const uint8_t* blob, int64_t blob_len, int64_t n_reads,
                      int32_t* counts, uint32_t* recs_out) {
  int64_t off = 0;
  int64_t w = 0;
  for (int64_t i = 0; i < n_reads; ++i) {
    if (off + 4 > blob_len) return -1;
    int32_t n;
    std::memcpy(&n, blob + off, 4);
    off += 4;
    if (n < 0 || off + (int64_t)n * 16 > blob_len) return -1;
    counts[i] = n;
    std::memcpy(recs_out + w * 4, blob + off, (size_t)n * 16);
    w += n;
    off += (int64_t)n * 16;
  }
  return off;
}

// Prefill the SA-interval walk cache with device-resolved values: for
// each interval i, vals[off[i]..off[i+1]) are the raw sa_walk values for
// rows ks[i]..ls[i] of (dbidx, strand) — computed by the device LF-walk
// engine (ibwa_tpu/fm/walk.py), bit-equal to the host walks.  After the
// first prefill, cached_walk consults the cache for every width.
void ibwa_pe_prefill_walks(void* pctx, int32_t dbidx, int32_t strand,
                           int64_t n_intervals, const uint32_t* ks,
                           const uint32_t* ls, const int64_t* off,
                           const uint32_t* vals) {
  PeCtx& ctx = *(PeCtx*)pctx;
  auto& slot = ctx.sa_cache[dbidx][strand];
  for (int64_t i = 0; i < n_intervals; ++i) {
    int64_t w = off[i + 1] - off[i];
    if (w <= 0 || ctx.cache_vals + (size_t)w > CACHE_MAX_VALS) continue;
    uint64_t key = ((uint64_t)ks[i] << 32) | ls[i];
    auto r = slot.emplace(key, std::vector<uint32_t>());
    if (!r.second) continue;  // already cached
    r.first->second.assign(vals + off[i], vals + off[i + 1]);
    ctx.cache_vals += (size_t)w;
  }
  ctx.prefilled = true;
}

// Interleave two per-file blob sets into end-read order (r0/file0,
// r0/file1, r1/file0, ...) for [start, start+n): the sampe emit path's
// input contract.  Writes 2n+1 offsets and the gathered bytes.  The
// equivalent numpy repeat+fancy-index gather cost ~1.1 s per 50k-pair
// batch; this is ~200k short memcpys.
void ibwa_interleave_blobs(const uint8_t* blob0, const int64_t* off0,
                           const uint8_t* blob1, const int64_t* off1,
                           int64_t start, int64_t n,
                           uint8_t* out_blob, int64_t* out_off) {
  int64_t w = 0;
  out_off[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t a = off0[start + i], b = off0[start + i + 1];
    std::memcpy(out_blob + w, blob0 + a, (size_t)(b - a));
    w += b - a;
    out_off[2 * i + 1] = w;
    a = off1[start + i]; b = off1[start + i + 1];
    std::memcpy(out_blob + w, blob1 + a, (size_t)(b - a));
    w += b - a;
    out_off[2 * i + 2] = w;
  }
}

}  // extern "C"
