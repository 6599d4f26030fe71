// Native linear-sum-assignment (Munkres/Hungarian) solver.
//
// Counterpart of the reference's COMPILED assignment core: the
// evaluation oracle's Munkres steps live in Cython
// (/root/reference/python/munkres_step4.pyx, driven by python/ospa.py:181-218)
// precisely because the pure-Python inner loops were too slow for batch
// OSPA scoring over 50-100 Monte-Carlo runs. This module plays the same
// role for eval/ospa.py, with scipy (if present) as the portable fallback.
//
// Algorithm: Jonker-Volgenant shortest-augmenting-path with dual potentials,
// O(m * n^2) for an m x n cost matrix with m <= n — the same optimum as the
// reference's classic Munkres steps 1-6, minimizing total cost.
//
// Exposes:
//   assign(cost: float64[m, n]) -> (rows int64[m], cols int64[m])
//     requires m <= n; returns the optimal row -> column matching.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <cstdint>
#include <limits>
#include <vector>

namespace {

// p[j] (1-based): row matched to column j, 0 = free. Standard JV recursion:
// grow an alternating tree from free row i with Dijkstra over reduced costs
// until a free column is reached, then flip the path.
void solve_lsap(const double* cost, int64_t m, int64_t n,
                std::vector<int64_t>& row_of_col) {
    const double INF = std::numeric_limits<double>::infinity();
    std::vector<double> u(m + 1, 0.0), v(n + 1, 0.0);
    std::vector<int64_t> p(n + 1, 0), way(n + 1, 0);
    for (int64_t i = 1; i <= m; ++i) {
        p[0] = i;
        int64_t j0 = 0;
        std::vector<double> minv(n + 1, INF);
        std::vector<char> used(n + 1, 0);
        do {
            used[j0] = 1;
            int64_t i0 = p[j0], j1 = 0;
            double delta = INF;
            const double* row = cost + (i0 - 1) * n;
            for (int64_t j = 1; j <= n; ++j) {
                if (used[j]) continue;
                double cur = row[j - 1] - u[i0] - v[j];
                if (cur < minv[j]) { minv[j] = cur; way[j] = j0; }
                if (minv[j] < delta) { delta = minv[j]; j1 = j; }
            }
            for (int64_t j = 0; j <= n; ++j) {
                if (used[j]) { u[p[j]] += delta; v[j] -= delta; }
                else          minv[j] -= delta;
            }
            j0 = j1;
        } while (p[j0] != 0);
        do {
            int64_t j1 = way[j0];
            p[j0] = p[j1];
            j0 = j1;
        } while (j0 != 0);
    }
    row_of_col.assign(p.begin() + 1, p.end());  // 1-based rows, 0 = free
}

PyObject* py_assign(PyObject*, PyObject* args) {
    PyObject* obj;
    if (!PyArg_ParseTuple(args, "O", &obj)) return nullptr;
    PyArrayObject* arr = reinterpret_cast<PyArrayObject*>(
        PyArray_FROM_OTF(obj, NPY_DOUBLE, NPY_ARRAY_IN_ARRAY));
    if (!arr) return nullptr;
    if (PyArray_NDIM(arr) != 2) {
        Py_DECREF(arr);
        PyErr_SetString(PyExc_ValueError, "cost must be 2-D");
        return nullptr;
    }
    int64_t m = PyArray_DIM(arr, 0), n = PyArray_DIM(arr, 1);
    if (m > n) {
        Py_DECREF(arr);
        PyErr_SetString(PyExc_ValueError, "assign requires m <= n");
        return nullptr;
    }
    const double* cost = static_cast<const double*>(PyArray_DATA(arr));
    for (int64_t k = 0; k < m * n; ++k) {
        if (!(cost[k] == cost[k]) ||
            cost[k] == std::numeric_limits<double>::infinity() ||
            cost[k] == -std::numeric_limits<double>::infinity()) {
            Py_DECREF(arr);
            PyErr_SetString(PyExc_ValueError, "cost must be finite");
            return nullptr;
        }
    }

    std::vector<int64_t> row_of_col;
    if (m > 0) {
        Py_BEGIN_ALLOW_THREADS
        solve_lsap(cost, m, n, row_of_col);
        Py_END_ALLOW_THREADS
    }
    Py_DECREF(arr);

    npy_intp dims[1] = {static_cast<npy_intp>(m)};
    PyObject* rows = PyArray_SimpleNew(1, dims, NPY_INT64);
    PyObject* cols = PyArray_SimpleNew(1, dims, NPY_INT64);
    if (!rows || !cols) { Py_XDECREF(rows); Py_XDECREF(cols); return nullptr; }
    int64_t* rp = static_cast<int64_t*>(
        PyArray_DATA(reinterpret_cast<PyArrayObject*>(rows)));
    int64_t* cp = static_cast<int64_t*>(
        PyArray_DATA(reinterpret_cast<PyArrayObject*>(cols)));
    int64_t k = 0;
    for (int64_t j = 0; j < static_cast<int64_t>(row_of_col.size()); ++j) {
        if (row_of_col[j] != 0 && k < m) {
            rp[k] = row_of_col[j] - 1;
            cp[k] = j;
            ++k;
        }
    }
    if (k != m) {  // JV invariant: every row matched; never return garbage
        Py_DECREF(rows); Py_DECREF(cols);
        PyErr_SetString(PyExc_RuntimeError,
                        "incomplete assignment (JV invariant violated)");
        return nullptr;
    }
    // sort by row index so output matches linear_sum_assignment's convention
    for (int64_t a = 1; a < k; ++a) {  // tiny m: insertion sort
        int64_t r0 = rp[a], c0 = cp[a], b = a - 1;
        while (b >= 0 && rp[b] > r0) { rp[b + 1] = rp[b]; cp[b + 1] = cp[b]; --b; }
        rp[b + 1] = r0; cp[b + 1] = c0;
    }
    return Py_BuildValue("(NN)", rows, cols);
}

PyMethodDef methods[] = {
    {"assign", py_assign, METH_VARARGS,
     "assign(cost[m, n]) -> (rows, cols) optimal min-cost matching, m <= n"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "munkres",
                      "native Hungarian assignment", -1, methods,
                      nullptr, nullptr, nullptr, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit_munkres(void) {
    import_array();
    return PyModule_Create(&module);
}
