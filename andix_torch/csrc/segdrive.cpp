// The segmented walk driver's host reconciliation (chain/segdrive.py):
// andix's ``chain.segmented.segmented_group_anchors`` rule for rule, with the
// sublanes held as arrays in one driver object and each dispatch's events
// split by one counting pass over their lane ids.
//
// The Python side owns only the loop around the walk callback:
//
//   h = segdrive_new(...)                  geometry and parameters
//   while segdrive_step(h, out) == 1:      next dispatch: lb, iters, maxev
//       segdrive_fill(h, arr)              its twelve int32 [lb] lane arrays
//       ... walk(arr, iters, maxev) ...    the device (the callback)
//       segdrive_absorb(h, ev, ...)        its events, exit state, fin flags
//   segdrive_result(h, ...)                (lanes, q, s, len), lane-major
//   segdrive_free(h)
//
// segdrive_step runs pass 1 (every segment cold), pass 2 (every segment
// j >= 1 from segment j - 1's cold exit) and the resolve rounds (entries
// validated left to right, the splice at the first event a repair shares
// with its segment's cold walk, budget extensions and the fall-back to the
// rest of the lane), each as one request batch that runs to completion
// over as many dispatches as its chunk caps and event budgets take.  It
// returns 1 while a dispatch is due, 0 when the group is walked and -1
// when the resolve did not converge within 4 k + 8 rounds.  No entry
// touches a Python object, so ctypes runs each without the interpreter
// lock; a driver is used by one thread at a time.

#include <algorithm>
#include <cstdint>
#include <new>
#include <vector>

namespace {

using i32 = int32_t;
using i64 = int64_t;

struct Ev {
    i32 q, s, len;
    bool operator==(const Ev& o) const {
        return q == o.q && s == o.s && len == o.len;
    }
};

using Stream = std::vector<Ev>;

// chain state across probes: (pos, qend = last q + len, diag = s - q)
struct Triple {
    i64 pos, qend, diag;
    bool operator==(const Triple& o) const {
        return pos == o.pos && qend == o.qend && diag == o.diag;
    }
};

// states with gap > threshold are equivalent: lucky anchors cannot fire
// again before the next accepted anchor
Triple canon(i64 pos, i64 qend, i64 diag, i64 thr) {
    if (pos - qend > thr) return {pos, pos - thr - 2, 0};
    return {pos, qend, diag};
}

struct State {
    i64 pos, lq, ls, ll;
};

// the device entry (pos, lq, ls, ll) realizing a canonical triple
State entry_of(const Triple& t) { return {t.pos, t.qend, t.qend + t.diag, 0}; }

Triple exit_of(const State& st, i64 thr) {
    return canon(st.pos, st.lq + st.ll, st.ls - st.lq, thr);
}

// one (lane, segment) sublane's geometry
struct Sub {
    i64 lane, j, start, end, row, qoff, qs, ss, rl, thr, qlen;
};

// a (possibly continuing) true-entry walk of one sublane
struct Attempt {
    bool live = false;  // attempted at all
    Triple entry{};
    State state{};
    Stream ev;
    bool done = false;
    i64 extensions = 0;
    i64 end = 0;
};

enum Kind : int { K_EMPTY, K_COLD, K_ATTEMPT, K_SPLICE };

// a resolved sublane's stream: nothing, its cold walk, its attempt, or
// attempt[:i + 1] + cold[c + 1:]
struct Resolved {
    bool set = false;
    Kind kind = K_EMPTY;
    i64 i = 0, c = 0;
    Triple exit{};
};

struct Request {
    i64 sub;
    State entry;
    i64 end;
    i64 budget;  // events it may still record
    bool cold;   // pass 1: into the cold stream, else into the attempt
};

enum Phase { P_COLD, P_PROVISIONAL, P_RESOLVE, P_DONE };

constexpr int N_FIELDS = 12;  // row qoff qs ss rl thr seg_end pos0 lq0 ls0 ll0 maxev

struct Driver {
    // parameters, read by the caller from chain/segdrive.py at call time
    i64 k, repair_events, max_extensions, chunk_iters0, chunk_iters_max, big,
        min_lanes;
    double chunk_budget_s, ns_per_lane_iter;

    std::vector<Sub> subs;  // lane-major, segments in order
    std::vector<std::pair<i64, i64>> lanes;  // [first sub, end sub) a lane
    std::vector<Stream> cold_ev;
    std::vector<State> cold_state;
    std::vector<Triple> cold_exit;
    std::vector<Attempt> att;
    std::vector<Resolved> res;

    Phase phase = P_COLD;
    i64 guard = 0;
    i64 total = 0;

    // the running request batch
    std::vector<Request> reqs;
    std::vector<i64> active;  // indices into reqs, in request order
    i64 chunk_iters = 0;
    i64 lb = 0, maxev = 0;  // the dispatch handed out
    std::vector<i64> got;
    std::vector<Ev*> dst;

    Stream& stream(const Request& r) {
        return r.cold ? cold_ev[r.sub] : att[r.sub].ev;
    }

    void finish(const Request& r, const State& st, bool done) {
        if (r.cold) {
            cold_state[r.sub] = st;
            return;
        }
        Attempt& a = att[r.sub];
        a.state = st;
        a.done = done;
    }

    void start_batch() {
        chunk_iters = chunk_iters0;
        active.clear();
        for (i64 i = 0; i < (i64)reqs.size(); ++i) {
            const Request& r = reqs[i];
            if (r.entry.pos >= r.end) {
                finish(r, r.entry, true);
            } else {
                active.push_back(i);
            }
        }
    }

    void issue(i64 sub, const State& entry, i64 end, i64 budget, bool cold) {
        reqs.push_back({sub, entry, end, budget, cold});
    }

    Attempt& fresh(i64 sub, const Triple& entry) {
        Attempt& a = att[sub];
        a.live = true;
        a.entry = entry;
        a.ev.clear();
        a.done = false;
        a.extensions = 0;
        a.end = subs[sub].end;
        return a;
    }

    void cold_requests() {
        reqs.clear();
        for (i64 i = 0; i < (i64)subs.size(); ++i) {
            const Sub& u = subs[i];
            State e = u.j == 0 ? State{0, 0, 0, 0}
                               : entry_of(canon(u.start, -big, 0, u.thr));
            issue(i, e, u.end, big, true);
        }
    }

    void provisional_requests() {
        for (i64 i = 0; i < (i64)subs.size(); ++i)
            cold_exit[i] = exit_of(cold_state[i], subs[i].thr);
        reqs.clear();
        for (i64 i = 0; i < (i64)subs.size(); ++i) {
            const Sub& u = subs[i];
            if (u.j == 0) continue;
            const Triple& prev = cold_exit[i - 1];
            if (prev.pos >= u.end) continue;
            fresh(i, prev);
            issue(i, entry_of(prev), u.end, repair_events, false);
        }
    }

    // the first repair event that its cold stream also recorded: (i, c)
    bool find_merge(const Stream& rep, const Stream& cold,
                    i64& i_out, i64& c_out) const {
        if (rep.empty() || cold.empty()) return false;
        for (i64 i = 0; i < (i64)rep.size(); ++i) {
            auto it = std::lower_bound(
                cold.begin(), cold.end(), rep[i].q,
                [](const Ev& e, i32 q) { return e.q < q; });
            if (it != cold.end() && *it == rep[i]) {
                i_out = i;
                c_out = it - cold.begin();
                return true;
            }
        }
        return false;
    }

    // one resolve round's requests, at most one a lane; false when every
    // sublane is resolved
    bool resolve_requests() {
        reqs.clear();
        for (const auto& span : lanes) {
            Triple cur{0, 0, 0};
            for (i64 i = span.first; i < span.second; ++i) {
                const Sub& u = subs[i];
                Resolved& r = res[i];
                if (r.set) {
                    cur = r.exit;
                    continue;
                }
                if (cur.pos >= u.end) {
                    r = {true, K_EMPTY, 0, 0, cur};
                    continue;
                }
                if (u.j == 0) {
                    r = {true, K_COLD, 0, 0, cold_exit[i]};
                    cur = cold_exit[i];
                    continue;
                }
                Attempt& a = att[i];
                if (!a.live || !(a.entry == cur)) {
                    fresh(i, cur);
                    issue(i, entry_of(cur), u.end, repair_events, false);
                    break;
                }
                i64 mi, mc;
                if (a.end == u.end && find_merge(a.ev, cold_ev[i], mi, mc)) {
                    r = {true, K_SPLICE, mi, mc, cold_exit[i]};
                    cur = cold_exit[i];
                    continue;
                }
                if (a.done) {
                    r = {true, K_ATTEMPT, 0, 0, exit_of(a.state, u.thr)};
                    cur = r.exit;
                    continue;
                }
                // out of event budget before merging: extend, or walk the
                // rest of the lane in one go
                a.extensions += 1;
                i64 end = u.end;
                if (a.extensions > max_extensions) {
                    end = u.qlen;
                    a.end = end;
                }
                issue(i, a.state, end,
                      a.extensions > max_extensions ? big : repair_events,
                      false);
                break;
            }
        }
        return !reqs.empty();
    }

    void finalize() {
        total = 0;
        for (i64 i = 0; i < (i64)subs.size(); ++i) {
            const Resolved& r = res[i];
            switch (r.kind) {
                case K_EMPTY: break;
                case K_COLD: total += cold_ev[i].size(); break;
                case K_ATTEMPT: total += att[i].ev.size(); break;
                case K_SPLICE:
                    total += r.i + 1 + (i64)cold_ev[i].size() - r.c - 1;
                    break;
            }
        }
    }

    // advance to the next dispatch (1), the end (0) or a resolve that did
    // not converge (-1)
    int step(i64* out) {
        for (;;) {
            if (!active.empty()) {
                lb = min_lanes;
                while (lb < (i64)active.size()) lb *= 2;
                i64 sec_cap = std::max<i64>(
                    256, (i64)(chunk_budget_s * 1e9 /
                               ((double)lb * ns_per_lane_iter)));
                maxev = reqs[active[0]].budget;
                for (i64 a : active) maxev = std::min(maxev, reqs[a].budget);
                out[0] = lb;
                out[1] = std::min(chunk_iters, sec_cap);
                out[2] = maxev;
                chunk_iters = std::min(
                    {chunk_iters * 2, chunk_iters_max, sec_cap});
                return 1;
            }
            switch (phase) {
                case P_COLD:
                    cold_requests();
                    phase = P_PROVISIONAL;
                    break;
                case P_PROVISIONAL:
                    provisional_requests();
                    phase = P_RESOLVE;
                    break;
                case P_RESOLVE:
                    if (!resolve_requests()) {
                        finalize();
                        phase = P_DONE;
                        out[0] = total;
                        return 0;
                    }
                    guard += 1;
                    if (guard > 4 * k + 8) {
                        out[0] = guard - 1;
                        return -1;
                    }
                    break;
                case P_DONE:
                    out[0] = total;
                    return 0;
            }
            start_batch();
        }
    }

    void fill(i32* arr) const {
        for (int f = 0; f < N_FIELDS; ++f) {
            i32 pad = f == 4 ? 1 : f == 5 ? (i32)big : 0;
            std::fill(arr + f * lb, arr + (f + 1) * lb, pad);
        }
        for (i64 i = 0; i < (i64)active.size(); ++i) {
            const Request& r = reqs[active[i]];
            const Sub& u = subs[r.sub];
            const i64 v[N_FIELDS] = {u.row, u.qoff, u.qs, u.ss, u.rl, u.thr,
                                     r.end, r.entry.pos, r.entry.lq,
                                     r.entry.ls, r.entry.ll, r.budget};
            for (int f = 0; f < N_FIELDS; ++f) arr[f * lb + i] = (i32)v[f];
        }
    }

    // the dispatch's [4, cnt] events (lane, q, s, len; each lane's in
    // chain order) into each request's stream, then its exit state
    void absorb(const i32* ev, i64 cnt, const i32* state, i64 stride,
                const uint8_t* fin) {
        const i64 n = active.size();
        const i32 *ev_lane = ev, *ev_q = ev + cnt, *ev_s = ev + 2 * cnt,
                  *ev_len = ev + 3 * cnt;
        got.assign(n, 0);
        for (i64 e = 0; e < cnt; ++e) {
            i32 l = ev_lane[e];
            if (l >= 0 && l < n) got[l] += 1;
        }
        dst.resize(n);
        for (i64 i = 0; i < n; ++i) {
            Stream& s = stream(reqs[active[i]]);
            size_t old = s.size();
            s.resize(old + got[i]);
            dst[i] = s.data() + old;
        }
        for (i64 e = 0; e < cnt; ++e) {
            i32 l = ev_lane[e];
            if (l >= 0 && l < n) *dst[l]++ = {ev_q[e], ev_s[e], ev_len[e]};
        }
        i64 kept = 0;
        for (i64 i = 0; i < n; ++i) {
            Request& r = reqs[active[i]];
            State st{state[i], state[stride + i], state[2 * stride + i],
                     state[3 * stride + i]};
            if (fin[i] && st.pos >= r.end) {
                finish(r, st, true);
            } else if (fin[i]) {
                // stopped by the event budget: re-issue a lane that only
                // hit the dispatch's (smaller) budget
                i64 left = r.budget - got[i];
                if (left > 0 && got[i] >= maxev && maxev > 0) {
                    r.entry = st;
                    r.budget = left;
                    active[kept++] = active[i];
                } else {
                    finish(r, st, false);
                }
            } else {
                // stopped by the chunk's iteration cap: resume
                r.entry = st;
                r.budget -= got[i];
                if (r.budget <= 0) {
                    finish(r, st, false);
                } else {
                    active[kept++] = active[i];
                }
            }
        }
        active.resize(kept);
    }

    void result(i32* lane_out, i32* q, i32* s, i32* len) const {
        i64 o = 0;
        auto put = [&](i64 lane, const Ev* a, const Ev* b) {
            for (; a < b; ++a, ++o) {
                lane_out[o] = (i32)lane;
                q[o] = a->q;
                s[o] = a->s;
                len[o] = a->len;
            }
        };
        for (i64 i = 0; i < (i64)subs.size(); ++i) {
            const Resolved& r = res[i];
            const Stream& c = cold_ev[i];
            const Stream& a = att[i].ev;
            switch (r.kind) {
                case K_EMPTY: break;
                case K_COLD: put(subs[i].lane, c.data(), c.data() + c.size()); break;
                case K_ATTEMPT: put(subs[i].lane, a.data(), a.data() + a.size()); break;
                case K_SPLICE:
                    put(subs[i].lane, a.data(), a.data() + r.i + 1);
                    put(subs[i].lane, c.data() + r.c + 1, c.data() + c.size());
                    break;
            }
        }
    }
};

}  // namespace

extern "C" {

// ip: k, REPAIR_EVENTS, MAX_EXTENSIONS, CHUNK_ITERS, CHUNK_ITERS_MAX, BIG,
// MIN_LANES; dp: CHUNK_BUDGET_S, NS_PER_LANE_ITER.  The lanes
// are (s, g) with q_len2d[s, g] > 0, s-major; each is cut into k segments
// as andix's chain.segmented.plan_segments cuts it.  NULL when out of memory.
void* segdrive_new(i64 sg, i64 gp, const i64* subj_starts, const i64* rs_lens,
                   const i64* thresholds, const i64* q_base, const i64* q_start,
                   const i64* q_len2d, const i64* ip, const double* dp) {
    Driver* d = new (std::nothrow) Driver();
    if (d == nullptr) return nullptr;
    try {
        d->k = ip[0];
        d->repair_events = ip[1];
        d->max_extensions = ip[2];
        d->chunk_iters0 = ip[3];
        d->chunk_iters_max = ip[4];
        d->big = ip[5];
        d->min_lanes = ip[6];
        d->chunk_budget_s = dp[0];
        d->ns_per_lane_iter = dp[1];
        for (i64 s = 0; s < sg; ++s) {
            for (i64 g = 0; g < gp; ++g) {
                i64 qlen = q_len2d[s * gp + g];
                if (qlen <= 0) continue;
                i64 lane = s * gp + g;
                i64 step = (qlen + d->k - 1) / d->k;
                i64 first = d->subs.size();
                for (i64 j = 0, n = 0; j < d->k; ++j) {
                    i64 st = std::min(j * step, qlen);
                    i64 en = std::min((j + 1) * step, qlen);
                    if (en <= st) continue;
                    d->subs.push_back({lane, n++, st, en, s, q_base[g],
                                       q_start[g], subj_starts[s], rs_lens[s],
                                       thresholds[s], qlen});
                }
                d->lanes.push_back({first, (i64)d->subs.size()});
            }
        }
        size_t n = d->subs.size();
        d->cold_ev.resize(n);
        d->cold_state.resize(n);
        d->cold_exit.resize(n);
        d->att.resize(n);
        d->res.resize(n);
    } catch (const std::bad_alloc&) {
        delete d;
        return nullptr;
    }
    return d;
}

// out: (lb, iteration cap, event budget) of the next dispatch (returns
// 1), the event count (0), or the rounds the resolve took (-1); -2 when
// out of memory
int segdrive_step(void* h, i64* out) {
    try {
        return static_cast<Driver*>(h)->step(out);
    } catch (const std::bad_alloc&) {
        return -2;
    }
}

// the dispatch's lane arrays: int32 [12, lb], row-major
void segdrive_fill(void* h, i32* arr) { static_cast<Driver*>(h)->fill(arr); }

// ev: int32 [4, cnt]; state: int32 [4, stride] (pos, lq, ls, ll); fin:
// one byte a lane.  0, or -2 when out of memory
int segdrive_absorb(void* h, const i32* ev, i64 cnt, const i32* state,
                    i64 stride, const uint8_t* fin) {
    try {
        static_cast<Driver*>(h)->absorb(ev, cnt, state, stride, fin);
        return 0;
    } catch (const std::bad_alloc&) {
        return -2;
    }
}

// each int32 [the count segdrive_step returned with 0]
void segdrive_result(void* h, i32* lanes, i32* q, i32* s, i32* len) {
    static_cast<Driver*>(h)->result(lanes, q, s, len);
}

void segdrive_free(void* h) { delete static_cast<Driver*>(h); }

}  // extern "C"
