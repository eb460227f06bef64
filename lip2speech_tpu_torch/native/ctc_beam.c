/* CTC prefix beam search (native host path).
 *
 * The reference links the C++ `ctcdecode` extension for CTC beam decoding
 * (multi_target_lip2speech/sequence_generator.py:27-38); this is the
 * equivalent native component for the port's host side. Semantics
 * mirror lip2speech_tpu_torch/data/text.py::ctc_beam_search exactly (same
 * per-frame top-k candidate pruning, same blank/repeat/extend merge rules),
 * so the Python implementation doubles as the test oracle.
 *
 * Prefixes live in a parent-pointer trie; a per-step open-addressing map
 * keyed by (node, label) deduplicates extensions, so prefix identity is
 * node identity and no sequence copying ever happens.
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define NEG_INF (-INFINITY)

static double logadd(double a, double b) {
    if (a == NEG_INF) return b;
    if (b == NEG_INF) return a;
    double m = a > b ? a : b;
    return m + log(exp(a - m) + exp(b - m));
}

typedef struct {        /* trie node = prefix */
    int32_t parent;     /* -1 for root */
    int32_t label;
    int32_t depth;
} Node;

typedef struct {
    int32_t node;
    double pb;          /* log P(prefix, ends in blank) */
    double pnb;         /* log P(prefix, ends in non-blank) */
} Beam;

/* open-addressing (node,label) -> slot-in-newbeams map, cleared per frame */
typedef struct {
    int64_t *keys;      /* (node << 20) | label; -1 = empty */
    int32_t *vals;
    size_t cap;
} Map;

static int32_t map_get_or_add(Map *m, int64_t key, int32_t next_val) {
    size_t h = ((uint64_t)key * 11400714819323198485ull) % m->cap;
    for (;;) {
        if (m->keys[h] == -1) {
            m->keys[h] = key;
            m->vals[h] = next_val;
            return -next_val - 2;   /* negative => newly inserted */
        }
        if (m->keys[h] == key) return m->vals[h];
        h = (h + 1) % m->cap;
    }
}

static int cmp_desc(const void *a, const void *b) {
    double sa = logadd(((const Beam *)a)->pb, ((const Beam *)a)->pnb);
    double sb = logadd(((const Beam *)b)->pb, ((const Beam *)b)->pnb);
    return sa < sb ? 1 : (sa > sb ? -1 : 0);
}

/* partial selection: put the k largest-log-prob class indices first.
 * Ties keep the HIGHER class index, matching the Python oracle's
 * np.argsort()[::-1] (reversed stable ascending sort). */
static void sort_topk(int32_t *idx, int32_t c, int32_t k, const float *lp) {
    for (int32_t i = 0; i < k; i++) {
        int32_t m = i;
        for (int32_t j = i + 1; j < c; j++)
            if (lp[idx[j]] > lp[idx[m]] ||
                (lp[idx[j]] == lp[idx[m]] && idx[j] > idx[m])) m = j;
        int32_t tmp = idx[i]; idx[i] = idx[m]; idx[m] = tmp;
    }
}

/* Returns length of best label sequence (written to out, capacity out_cap),
 * score in *out_score; -1 on allocation failure, -2 if out_cap too small. */
int64_t ctc_beam_search_f32(const float *log_probs, int64_t t_len, int64_t c,
                            int32_t beam_width, int32_t blank,
                            int32_t *out, int64_t out_cap,
                            double *out_score) {
    if (beam_width < 1) beam_width = 1;
    /* hash keys pack (node << 20) | label: labels must fit in 20 bits or
     * (node,label) pairs alias and beam merging silently corrupts */
    if (c >= (1 << 20)) return -1;
    int32_t k = beam_width > 8 ? beam_width : 8;   /* top-k classes/frame */
    if (k > c) k = (int32_t)c;

    size_t max_nodes = (size_t)(t_len + 1) * beam_width * (k + 1) + 16;
    Node *nodes = malloc(max_nodes * sizeof(Node));
    size_t max_new = (size_t)beam_width * (k + 2) + 8;
    Beam *beams = malloc(beam_width * sizeof(Beam));
    Beam *nbeams = malloc(max_new * sizeof(Beam));
    int32_t *topk = malloc(c * sizeof(int32_t));
    Map map;                       /* per-frame: resulting node -> slot */
    map.cap = max_new * 4;
    map.keys = malloc(map.cap * sizeof(int64_t));
    map.vals = malloc(map.cap * sizeof(int32_t));
    Map trie;                      /* persistent: (parent,label) -> child */
    trie.cap = max_nodes * 2 + 16;
    trie.keys = malloc(trie.cap * sizeof(int64_t));
    trie.vals = malloc(trie.cap * sizeof(int32_t));
    if (!nodes || !beams || !nbeams || !topk || !map.keys || !map.vals ||
        !trie.keys || !trie.vals) {
        free(nodes); free(beams); free(nbeams); free(topk);
        free(map.keys); free(map.vals); free(trie.keys); free(trie.vals);
        return -1;
    }
    memset(trie.keys, 0xff, trie.cap * sizeof(int64_t));

    size_t n_nodes = 1;
    nodes[0] = (Node){-1, -1, 0};               /* root = empty prefix */
    int32_t n_beams = 1;
    beams[0] = (Beam){0, 0.0, NEG_INF};

    for (int64_t t = 0; t < t_len; t++) {
        const float *lp = log_probs + t * c;
        for (int32_t i = 0; i < (int32_t)c; i++) topk[i] = i;
        sort_topk(topk, (int32_t)c, k, lp);

        int32_t n_new = 0;
        memset(map.keys, 0xff, map.cap * sizeof(int64_t));

        for (int32_t bi = 0; bi < n_beams; bi++) {
            Beam *src = &beams[bi];
            int32_t last = nodes[src->node].label;  /* -1 at root */
            for (int32_t ki = 0; ki < k; ki++) {
                int32_t lab = topk[ki];
                double p = lp[lab];
                /* resulting prefix node: unchanged for blank/repeat, the
                 * (persistent) trie child for an extension */
                int32_t dst;
                if (lab == blank || lab == last) {
                    dst = src->node;
                } else {
                    int64_t tkey = ((int64_t)src->node << 20) | lab;
                    int32_t child = map_get_or_add(&trie, tkey,
                                                   (int32_t)n_nodes);
                    if (child < 0) {
                        nodes[n_nodes] = (Node){src->node, lab,
                                                nodes[src->node].depth + 1};
                        child = (int32_t)n_nodes;
                        n_nodes++;
                    }
                    dst = child;
                }
                int32_t slot = map_get_or_add(&map, (int64_t)dst, n_new);
                if (slot < 0) {
                    slot = -slot - 2;
                    nbeams[slot] = (Beam){dst, NEG_INF, NEG_INF};
                    n_new++;
                }
                if (lab == blank) {
                    nbeams[slot].pb = logadd(nbeams[slot].pb,
                                             logadd(src->pb + p,
                                                    src->pnb + p));
                } else if (lab == last) {
                    /* repeat collapses onto the same prefix ... */
                    nbeams[slot].pnb = logadd(nbeams[slot].pnb, src->pnb + p);
                    /* ... or starts a new copy via the blank path */
                    int64_t tkey = ((int64_t)src->node << 20) | lab;
                    int32_t child = map_get_or_add(&trie, tkey,
                                                   (int32_t)n_nodes);
                    if (child < 0) {
                        nodes[n_nodes] = (Node){src->node, lab,
                                                nodes[src->node].depth + 1};
                        child = (int32_t)n_nodes;
                        n_nodes++;
                    }
                    int32_t slot2 = map_get_or_add(&map, (int64_t)child,
                                                   n_new);
                    if (slot2 < 0) {
                        slot2 = -slot2 - 2;
                        nbeams[slot2] = (Beam){child, NEG_INF, NEG_INF};
                        n_new++;
                    }
                    nbeams[slot2].pnb = logadd(nbeams[slot2].pnb,
                                               src->pb + p);
                } else {
                    nbeams[slot].pnb = logadd(nbeams[slot].pnb,
                                              logadd(src->pb + p,
                                                     src->pnb + p));
                }
            }
        }
        /* prune to beam_width best by total log-prob */
        qsort(nbeams, n_new, sizeof(Beam), cmp_desc);
        n_beams = n_new < beam_width ? n_new : beam_width;
        memcpy(beams, nbeams, n_beams * sizeof(Beam));
    }

    /* best beam -> write labels root-first */
    int32_t best = 0;
    double best_score = NEG_INF;
    for (int32_t i = 0; i < n_beams; i++) {
        double s = logadd(beams[i].pb, beams[i].pnb);
        if (s > best_score) { best_score = s; best = i; }
    }
    int32_t depth = nodes[beams[best].node].depth;
    int64_t ret;
    if (depth > out_cap) {
        ret = -2;
    } else {
        int32_t cur = beams[best].node;
        for (int32_t i = depth - 1; i >= 0; i--) {
            out[i] = nodes[cur].label;
            cur = nodes[cur].parent;
        }
        *out_score = best_score;
        ret = depth;
    }
    free(nodes); free(beams); free(nbeams); free(topk);
    free(map.keys); free(map.vals); free(trie.keys); free(trie.vals);
    return ret;
}
