// Native co-visibility group-layout builder + edge packer.
//
// C++ replacement for the host hot path of structure analysis
// (solver/groups.py build_group_layout + the _take/renumber packing loops in
// solver/block_solver.py initialize_from_arrays) -- the analogue of
// the reference's host symbolic stage + arena edge packing
// (/root/reference/src/sparse_block_matrix.cpp:63-156,
//  /root/reference/src/optimisable_graph.hpp:475-572).
//
// The numpy implementation remains the fallback and the parity oracle: every
// array emitted here is BIT-IDENTICAL to solver/groups.py's output (pinned by
// tests/test_native_layout.py).  All sorts are stable counting/radix sorts,
// matching numpy's kind="stable" semantics on integer keys.
//
// Two-call protocol (output sizes are data-dependent):
//   1. tba_layout_analyze: degree classes, per-class tuple grouping (stable
//      LSD radix over pose ids), chunk-width choice, per-class sizes.  The
//      per-class landmark order + group ids persist into caller scratch.
//   2. tba_layout_emit: edge_perm / lm_order / lm_renumber / out_key /
//      chunk_pose / fix_rows from the scratch, no re-sorting.
//   3. tba_pack_edges: gather measurement/omega/active payloads into layout
//      order with dummy-row fills, one fused pass (replaces 3-4 numpy fancy
//      gathers + the per-class pos_in_class loop).
//
// Build: python -m cuda_bundle_adjustment_tpu.native.build

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// stable counting sort of idx[] by key[idx], keys in [0, K)
void counting_sort(const int64_t* key, int64_t* idx, int64_t* tmp, int64_t n,
                   int64_t K, std::vector<int64_t>& cnt)
{
    cnt.assign(K + 1, 0);
    for (int64_t i = 0; i < n; ++i)
    {
        ++cnt[key[idx[i]] + 1];
    }
    for (int64_t k = 0; k < K; ++k)
    {
        cnt[k + 1] += cnt[k];
    }
    for (int64_t i = 0; i < n; ++i)
    {
        tmp[cnt[key[idx[i]]]++] = idx[i];
    }
    std::memcpy(idx, tmp, n * sizeof(int64_t));
}

double model_cost(int64_t nc_pad, int64_t d, int64_t g, int64_t npairs)
{
    const double EDGE_NS = 35.0, OUT_NS = 63.0;
    return EDGE_NS * double(d) * double(g) * double(nc_pad) +
           OUT_NS * double(npairs) * double(nc_pad);
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Call 1: analysis.
//
// Inputs: pose_idx/lm_idx [E], Pa, La, gc_max, tile_n.
// Scratch (caller-allocated):
//   sort_buf   [E]      int64
//   lm_sorted  [E]      int64   (out: free-edge row ids sorted by (lm, pose))
//   deg        [La]     int64   (out: both-free degree per landmark)
//   lms_s_all  [La]     int64   (out: per-class concatenated sorted landmarks)
//   gid_all    [La]     int64   (out: group id within class, aligned with
//                                lms_s_all)
// Outputs:
//   class_d / class_ld / class_nc / class_gc / class_npairs [max_classes]
//   out_fix_count [1]: total duplicate-pose fix rows (sizes emit's fix_rows)
// Returns number of classes, or -1 if max_classes too small.
int64_t tba_layout_analyze(
    const int64_t* pose_idx, const int64_t* lm_idx, int64_t E,
    int64_t Pa, int64_t La, int64_t gc_max, int64_t tile_n,
    int64_t* sort_buf, int64_t* lm_sorted, int64_t* deg,
    int64_t* lms_s_all, int64_t* gid_all,
    int64_t max_classes,
    int64_t* class_d, int64_t* class_ld, int64_t* class_nc,
    int64_t* class_gc, int64_t* class_npairs, int64_t* out_fix_count)
{
    *out_fix_count = 0;
    // --- free edges sorted by (lm, pose), stable: two counting passes ------
    // payload-carrying LSD radix: the (lm, pose, row) triples are reordered
    // together each pass so every read is sequential (a key[idx[i]] gather
    // form costs ~3x in cache misses at 561k edges)
    int64_t nfree = 0;
    std::vector<int64_t> cnt;
    {
        std::vector<int64_t> kp, kl, kp2, kl2;
        kp.reserve(E);
        kl.reserve(E);
        for (int64_t e = 0; e < E; ++e)
        {
            if (pose_idx[e] < Pa && lm_idx[e] < La)
            {
                lm_sorted[nfree] = e;
                kp.push_back(pose_idx[e]);
                kl.push_back(lm_idx[e]);
                ++nfree;
            }
        }
        kp2.resize(nfree);
        kl2.resize(nfree);
        // pass 1: by pose
        cnt.assign(Pa + 1, 0);
        for (int64_t i = 0; i < nfree; ++i)
        {
            ++cnt[kp[i] + 1];
        }
        for (int64_t k = 0; k < Pa; ++k)
        {
            cnt[k + 1] += cnt[k];
        }
        for (int64_t i = 0; i < nfree; ++i)
        {
            const int64_t o = cnt[kp[i]]++;
            sort_buf[o] = lm_sorted[i];
            kl2[o] = kl[i];
            kp2[o] = kp[i];
        }
        // pass 2: by landmark
        cnt.assign(La + 1, 0);
        for (int64_t i = 0; i < nfree; ++i)
        {
            ++cnt[kl2[i] + 1];
        }
        for (int64_t k = 0; k < La; ++k)
        {
            cnt[k + 1] += cnt[k];
        }
        for (int64_t i = 0; i < nfree; ++i)
        {
            lm_sorted[cnt[kl2[i]]++] = sort_buf[i];
        }
    }

    // --- degrees + run starts ---------------------------------------------
    for (int64_t l = 0; l < La; ++l)
    {
        deg[l] = 0;
    }
    for (int64_t i = 0; i < nfree; ++i)
    {
        ++deg[lm_idx[lm_sorted[i]]];
    }
    int64_t dmax = 0;
    for (int64_t l = 0; l < La; ++l)
    {
        if (deg[l] > dmax)
        {
            dmax = deg[l];
        }
    }

    // run start of each landmark within lm_sorted (prefix over deg)
    std::vector<int64_t> run_start(La + 1, 0);
    for (int64_t l = 0; l < La; ++l)
    {
        run_start[l + 1] = run_start[l] + deg[l];
    }

    // --- per-degree classes ------------------------------------------------
    int64_t n_classes = 0;
    int64_t lms_cursor = 0;
    std::vector<int64_t> cls_lms, order, tmp, key;
    for (int64_t d = 1; d <= dmax; ++d)
    {
        cls_lms.clear();
        for (int64_t l = 0; l < La; ++l)
        {
            if (deg[l] == d)
            {
                cls_lms.push_back(l);
            }
        }
        const int64_t Ld = int64_t(cls_lms.size());
        if (Ld == 0)
        {
            continue;
        }
        if (n_classes >= max_classes)
        {
            return -1;
        }
        // stable lexicographic sort of the pose tuples: LSD radix, counting
        // sort per tuple position from last to first (== numpy stable
        // argsort on the combined key)
        order.resize(Ld);
        tmp.resize(Ld);
        key.resize(Ld);
        for (int64_t i = 0; i < Ld; ++i)
        {
            order[i] = i;
        }
        for (int64_t j = d - 1; j >= 0; --j)
        {
            for (int64_t i = 0; i < Ld; ++i)
            {
                key[i] = pose_idx[lm_sorted[run_start[cls_lms[i]] + j]];
            }
            counting_sort(key.data(), order.data(), tmp.data(), Ld, Pa, cnt);
        }
        // group boundaries + sizes
        int64_t ngroups = 0;
        int64_t* lms_s = lms_s_all + lms_cursor;
        int64_t* gid = gid_all + lms_cursor;
        for (int64_t i = 0; i < Ld; ++i)
        {
            const int64_t l = cls_lms[order[i]];
            lms_s[i] = l;
            bool newg = (i == 0);
            if (!newg)
            {
                const int64_t lp = lms_s[i - 1];
                for (int64_t j = 0; j < d; ++j)
                {
                    if (pose_idx[lm_sorted[run_start[l] + j]] !=
                        pose_idx[lm_sorted[run_start[lp] + j]])
                    {
                        newg = true;
                        break;
                    }
                }
            }
            if (newg)
            {
                ++ngroups;
            }
            gid[i] = ngroups - 1;
        }
        // chunk width: ALWAYS gc_max, matching solver/groups.py _choose_gc
        // (model_cost kept for reference)
        std::vector<int64_t> gsz(ngroups, 0);
        for (int64_t i = 0; i < Ld; ++i)
        {
            ++gsz[gid[i]];
        }
        const int64_t npairs = d * (d + 1) / 2;
        (void)model_cost;
        const int64_t best_g = gc_max;
        int64_t nc = 0;
        for (int64_t gi = 0; gi < ngroups; ++gi)
        {
            nc += (gsz[gi] + best_g - 1) / best_g;
        }
        // duplicate-pose fix rows: one per (unordered pair a<b with equal
        // poses, chunk) — every chunk member shares the tuple, so walk the
        // chunk starts (member index multiple of best_g within its group)
        {
            int64_t member = 0;
            for (int64_t i = 0; i < Ld; ++i)
            {
                if (i > 0 && gid[i] != gid[i - 1])
                {
                    member = 0;
                }
                if (member % best_g == 0)
                {
                    const int64_t l = lms_s[i];
                    int64_t dup = 0;
                    for (int64_t a = 0; a < d; ++a)
                    {
                        for (int64_t b = a + 1; b < d; ++b)
                        {
                            if (pose_idx[lm_sorted[run_start[l] + a]] ==
                                pose_idx[lm_sorted[run_start[l] + b]])
                            {
                                ++dup;
                            }
                        }
                    }
                    *out_fix_count += dup;
                }
                ++member;
            }
        }
        class_d[n_classes] = d;
        class_ld[n_classes] = Ld;
        class_nc[n_classes] = nc;
        class_gc[n_classes] = best_g;
        class_npairs[n_classes] = npairs;
        ++n_classes;
        lms_cursor += Ld;
    }
    return n_classes;
}

// ---------------------------------------------------------------------------
// Call 2: emission.  All cursors/sizes derived host-side from call 1.
//
// Inputs: everything from call 1 (lm_sorted/deg/lms_s_all/gid_all persist),
// per-class geometry (nc_pad etc. recomputed from class_nc by the caller).
// Outputs sized exactly:
//   edge_perm [e_total]   (-1 dummy rows; extras appended by caller)
//   lm_order  [la_pad]    (-1 dummy slots; d0 region appended by caller)
//   lm_renumber [La]      (-1 for untouched; d0 region filled by caller)
//   out_key   [n_out]     (-1 dummy chunks)
//   chunk_pose [cp_total] (-1 dummy chunks)
//   fix_rows  [fix_cap]   returns fix count (call with fix_cap=0 to size)
int64_t tba_layout_emit(
    const int64_t* pose_idx, int64_t Pa,
    const int64_t* lm_sorted, const int64_t* deg,
    const int64_t* lms_s_all, const int64_t* gid_all,
    int64_t n_classes,
    const int64_t* class_d, const int64_t* class_ld, const int64_t* class_nc,
    const int64_t* class_gc, int64_t tile_n, int64_t La,
    int64_t* edge_perm, int64_t* lm_order, int64_t* lm_renumber,
    int64_t* out_key, int64_t* chunk_pose,
    int64_t* fix_rows, int64_t fix_cap)
{
    std::vector<int64_t> run_start(La + 1, 0);
    for (int64_t l = 0; l < La; ++l)
    {
        run_start[l + 1] = run_start[l] + deg[l];
    }
    for (int64_t l = 0; l < La; ++l)
    {
        lm_renumber[l] = -1;
    }

    int64_t lms_cursor = 0;
    int64_t e_cursor = 0, lm_cursor = 0, out_cursor = 0, cp_cursor = 0;
    int64_t fix_count = 0;
    std::vector<int64_t> chunk_first;  // representative landmark per chunk
    for (int64_t ci = 0; ci < n_classes; ++ci)
    {
        const int64_t d = class_d[ci];
        const int64_t Ld = class_ld[ci];
        const int64_t nc = class_nc[ci];
        const int64_t g = class_gc[ci];
        const int64_t nc_pad = (nc + tile_n - 1) / tile_n * tile_n;
        const int64_t npairs = d * (d + 1) / 2;
        const int64_t slot_stride = g * nc_pad;
        const int64_t* lms_s = lms_s_all + lms_cursor;
        const int64_t* gid = gid_all + lms_cursor;

        for (int64_t i = 0; i < d * slot_stride; ++i)
        {
            edge_perm[e_cursor + i] = -1;
        }
        for (int64_t i = 0; i < slot_stride; ++i)
        {
            lm_order[lm_cursor + i] = -1;
        }

        chunk_first.assign(nc, -1);
        int64_t chunk_base = 0;   // chunks of all previous groups
        int64_t member = 0;       // member index within current group
        for (int64_t i = 0; i < Ld; ++i)
        {
            if (i > 0 && gid[i] != gid[i - 1])
            {
                chunk_base += (member + g - 1) / g;  // chunks of closed group
                member = 0;
            }
            const int64_t c = chunk_base + member / g;
            const int64_t m = member % g;
            const int64_t l = lms_s[i];
            const int64_t pos = lm_cursor + m * nc_pad + c;
            lm_renumber[l] = pos;
            lm_order[pos - lm_cursor + lm_cursor] = l;  // == lm_order[pos]
            for (int64_t a = 0; a < d; ++a)
            {
                edge_perm[e_cursor + a * slot_stride + m * nc_pad + c] =
                    lm_sorted[run_start[l] + a];
            }
            chunk_first[c] = l;  // last member wins (same tuple either way)
            ++member;
        }

        // out_key [npairs, nc_pad] row-major + chunk_pose [d, nc_pad] +
        // fix rows, matching groups.py's dup enumeration order (pair-major)
        for (int64_t i = 0; i < npairs * nc_pad; ++i)
        {
            out_key[out_cursor + i] = -1;
        }
        for (int64_t i = 0; i < d * nc_pad; ++i)
        {
            chunk_pose[cp_cursor + i] = -1;
        }
        int64_t pr = 0;
        for (int64_t a = 0; a < d; ++a)
        {
            for (int64_t b = a; b < d; ++b, ++pr)
            {
                int64_t* row = out_key + out_cursor + pr * nc_pad;
                for (int64_t c = 0; c < nc; ++c)
                {
                    const int64_t l = chunk_first[c];
                    const int64_t sa = pose_idx[lm_sorted[run_start[l] + a]];
                    const int64_t sb = pose_idx[lm_sorted[run_start[l] + b]];
                    row[c] = sa * Pa + sb;
                    if (a != b && sa == sb)
                    {
                        if (fix_count < fix_cap)
                        {
                            fix_rows[fix_count] =
                                out_cursor + pr * nc_pad + c;
                        }
                        ++fix_count;
                    }
                }
            }
        }
        for (int64_t a = 0; a < d; ++a)
        {
            int64_t* row = chunk_pose + cp_cursor + a * nc_pad;
            for (int64_t c = 0; c < nc; ++c)
            {
                row[c] = pose_idx[lm_sorted[run_start[chunk_first[c]] + a]];
            }
        }

        lms_cursor += Ld;
        e_cursor += d * slot_stride;
        lm_cursor += slot_stride;
        out_cursor += npairs * nc_pad;
        cp_cursor += d * nc_pad;
    }
    return fix_count;
}

// ---------------------------------------------------------------------------
// Call 3: fused edge packing (replaces the numpy _take gathers + renumber +
// pos_in_class loops in initialize_from_arrays).
//
// For each packed row r (0 <= r < e_total):
//   src = edge_perm[r]; dummy rows (src < 0) get fills.
//   meas_out[:, r]   = meas[src, :M] (0 for dummies; stereo pad row 0)
//   omega_out[r]     = omega[src] or broadcast omega[0] upstream
//   active_out[r]    = active[src] > 0 (0 for dummies)
//   mask3_out[r]     = mask3[src] (if given)
//   pose_out[r]      = pose_idx[src] (Pa for dummies)
//   lm_out[r]        = renumbered landmark (dummy: the slot's own position,
//                      = lm_start + (r - e_start) % slot_stride, from the
//                      class table)
//
// meas_cols < e_total selects COMPACT measurement emission: rows with
// active_out == 1 write their meas at consecutive columns of the
// [M_out, meas_cols] buffer (inactive/dummy rows write nothing) — the
// device side restores the padded layout with one monotone gather keyed on
// active_out (solver/block_solver.py _pack_device_cm_derived), cutting the
// measurement upload by the dummy fraction (~26% at KITTI-00 scale).
// Returns the number of compact columns written (== meas_cols expected).
int64_t tba_pack_edges(
    const int64_t* edge_perm, int64_t e_total,
    const double* meas, int64_t M_in, int64_t M_out,
    const double* omega, int64_t has_per_edge_omega,
    const double* active,
    const double* mask3, int64_t has_mask3,
    const int64_t* pose_idx, const int64_t* lm_idx,
    const int64_t* lm_renumber_full,  // [max lm id + 1] new id per landmark
    int64_t Pa,
    int64_t n_classes, const int64_t* class_e_start,
    const int64_t* class_lm_start, const int64_t* class_slot_stride,
    int64_t meas_cols,         // e_total (padded) or n_active (compact)
    double* meas_out,          // [M_out, meas_cols] component-major
    double* omega_out,         // [e_total] (only if has_per_edge_omega)
    int8_t* active_out,        // [e_total]
    int8_t* mask3_out,         // [e_total] (only if has_mask3)
    int16_t* pose_out16,       // [e_total] (Pa+1 < 2^15 path) or null
    int32_t* pose_out32,       // [e_total] or null
    int32_t* lm_out)           // [e_total]
{
    const bool compact = meas_cols < e_total;
    int64_t mpos = 0;
    // class lookup per row: walk the class table once (rows are class-major)
    int64_t ci = 0;
    for (int64_t r = 0; r < e_total; ++r)
    {
        while (ci + 1 < n_classes && r >= class_e_start[ci + 1])
        {
            ++ci;
        }
        const int64_t src = edge_perm[r];
        if (src >= 0)
        {
            const int8_t act = active[src] > 0.0 ? 1 : 0;
            if (!compact || act)
            {
                const int64_t mc = compact ? mpos++ : r;
                for (int64_t k = 0; k < M_in; ++k)
                {
                    meas_out[k * meas_cols + mc] = meas[src * M_in + k];
                }
                for (int64_t k = M_in; k < M_out; ++k)
                {
                    meas_out[k * meas_cols + mc] = 0.0;
                }
            }
            if (has_per_edge_omega)
            {
                omega_out[r] = omega[src];
            }
            active_out[r] = act;
            if (has_mask3)
            {
                mask3_out[r] = mask3[src] > 0.0 ? 1 : 0;
            }
            const int64_t p = pose_idx[src];
            if (pose_out16)
            {
                pose_out16[r] = static_cast<int16_t>(p);
            }
            else
            {
                pose_out32[r] = static_cast<int32_t>(p);
            }
            lm_out[r] = static_cast<int32_t>(lm_renumber_full[lm_idx[src]]);
        }
        else
        {
            if (!compact)
            {
                for (int64_t k = 0; k < M_out; ++k)
                {
                    meas_out[k * meas_cols + r] = 0.0;
                }
            }
            if (has_per_edge_omega)
            {
                omega_out[r] = 0.0;
            }
            active_out[r] = 0;
            if (has_mask3)
            {
                mask3_out[r] = 0;
            }
            if (pose_out16)
            {
                pose_out16[r] = static_cast<int16_t>(Pa);
            }
            else
            {
                pose_out32[r] = static_cast<int32_t>(Pa);
            }
            const int64_t in_class = r - class_e_start[ci];
            lm_out[r] = static_cast<int32_t>(
                class_lm_start[ci] + in_class % class_slot_stride[ci]);
        }
    }
    return compact ? mpos : e_total;
}

// ---------------------------------------------------------------------------
// O(E) pose-bandwidth bound (solver/ordering.py plan_pose_order's cheap
// pre-check): bw = max over landmarks of (max observing pose - min observing
// pose) among both-free edges.  One sequential pass.
int64_t tba_pose_band_bound(
    const int64_t* pose_idx, const int64_t* lm_idx, int64_t E,
    int64_t Pa, int64_t La,
    int64_t* pmin /* scratch [La] */, int64_t* pmax /* scratch [La] */)
{
    for (int64_t l = 0; l < La; ++l)
    {
        pmin[l] = Pa;
        pmax[l] = -1;
    }
    for (int64_t e = 0; e < E; ++e)
    {
        const int64_t p = pose_idx[e];
        const int64_t l = lm_idx[e];
        if (p < Pa && l < La)
        {
            if (p < pmin[l])
            {
                pmin[l] = p;
            }
            if (p > pmax[l])
            {
                pmax[l] = p;
            }
        }
    }
    int64_t bw = 0;
    for (int64_t l = 0; l < La; ++l)
    {
        if (pmax[l] >= 0 && pmax[l] - pmin[l] > bw)
        {
            bw = pmax[l] - pmin[l];
        }
    }
    return bw;
}

}  // extern "C"
