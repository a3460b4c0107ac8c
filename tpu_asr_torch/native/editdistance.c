/* Levenshtein edit distance: the port's copy of native/editdistance.c with a
 * plain C interface, loaded by ctypes (tpu_asr_torch/native/__init__.py)
 * instead of the CPython C API. The original compares Python objects with
 * PyObject_RichCompare(Py_EQ); here the caller maps the two sequences' items
 * to integer ids first (equal items, one id), and the recurrence is the
 * original's.
 *
 * long tat_edit_distance(a, n, b, m): the distance between the id sequences
 * a[0..n) and b[0..m), or -1 when out of memory.
 */
#include <stdint.h>
#include <stdlib.h>

long tat_edit_distance(const int64_t *a, int64_t n, const int64_t *b,
                       int64_t m) {
    long *prev = (long *)malloc(sizeof(long) * (size_t)(m + 1));
    long *cur = (long *)malloc(sizeof(long) * (size_t)(m + 1));
    if (!prev || !cur) {
        free(prev); free(cur);
        return -1;
    }
    for (int64_t j = 0; j <= m; j++) prev[j] = (long)j;
    for (int64_t i = 1; i <= n; i++) {
        cur[0] = (long)i;
        for (int64_t j = 1; j <= m; j++) {
            int eq = a[i - 1] == b[j - 1];
            long sub = prev[j - 1] + (eq ? 0 : 1);
            long del = prev[j] + 1;
            long ins = cur[j - 1] + 1;
            long best = sub < del ? sub : del;
            cur[j] = best < ins ? best : ins;
        }
        long *tmp = prev; prev = cur; cur = tmp;
    }
    long result = prev[m];
    free(prev); free(cur);
    return result;
}
