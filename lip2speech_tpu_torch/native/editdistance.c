/* Levenshtein distance over int32 sequences.
 *
 * Native replacement for the reference's `editdistance` C extension
 * (used for unit-level WER, reference inference.py:299-317). Unit
 * sequences reach 2 x 600 = 1200 tokens; the O(n*m) DP is ~1.4M cells
 * per pair — pure Python costs ~1 s/pair, this runs in ~1 ms.
 *
 * Built at first use by lip2speech_tpu_torch/native/__init__.py (cc -O2
 * -shared), loaded via ctypes. No Python.h dependency.
 */

#include <stdint.h>
#include <stdlib.h>

int64_t edit_distance_i32(const int32_t *a, int64_t n,
                          const int32_t *b, int64_t m) {
    if (n == 0) return m;
    if (m == 0) return n;

    int64_t *prev = (int64_t *)malloc((size_t)(m + 1) * sizeof(int64_t));
    int64_t *cur = (int64_t *)malloc((size_t)(m + 1) * sizeof(int64_t));
    if (!prev || !cur) {
        free(prev);
        free(cur);
        return -1;
    }
    for (int64_t j = 0; j <= m; ++j) prev[j] = j;

    for (int64_t i = 1; i <= n; ++i) {
        cur[0] = i;
        int32_t ai = a[i - 1];
        for (int64_t j = 1; j <= m; ++j) {
            int64_t sub = prev[j - 1] + (ai != b[j - 1]);
            int64_t del = prev[j] + 1;
            int64_t ins = cur[j - 1] + 1;
            int64_t best = sub < del ? sub : del;
            cur[j] = best < ins ? best : ins;
        }
        int64_t *tmp = prev;
        prev = cur;
        cur = tmp;
    }
    int64_t out = prev[m];
    free(prev);
    free(cur);
    return out;
}
