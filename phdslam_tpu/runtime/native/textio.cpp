// Native text-IO fast path for dataset parsing and log writing.
//
// Counterpart of the reference's C++ loaders/writers
// (/root/reference/src/main.cpp:147-283 loadMeasurements/loadControls,
// :848-954 writeLog). The Python implementations in runtime/io.py are the
// portable fallback; this extension accelerates the host-side IO so large
// Monte-Carlo batches (100 runs x 1000 steps, SURVEY.md §4) don't bottleneck
// on Python float parsing.
//
// Exposes:
//   load_measurements(path, labeled=False) -> list[np.ndarray[n_i, 2|3]]
//   load_controls(path)                    -> np.ndarray[N, 2]
//   write_state_lines(path, lines)         -> None  (bulk '%g'-formatted rows)

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <cerrno>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

// Parse every whitespace-separated float on one line into out.
void parse_line(const char* s, std::vector<float>& out) {
    out.clear();
    const char* p = s;
    char* end = nullptr;
    while (*p) {
        while (*p == ' ' || *p == '\t' || *p == ',' || *p == '\r') ++p;
        if (*p == '\0' || *p == '\n') break;
        float v = strtof(p, &end);
        if (end == p) break;  // not a number: stop (matches fscanf bailout)
        out.push_back(v);
        p = end;
    }
}

PyObject* make_array(const std::vector<float>& vals, int width) {
    npy_intp n = static_cast<npy_intp>(vals.size()) / width;
    npy_intp dims[2] = {n, width};
    PyObject* arr = PyArray_SimpleNew(2, dims, NPY_FLOAT32);
    if (!arr) return nullptr;
    if (n > 0) {
        std::memcpy(PyArray_DATA(reinterpret_cast<PyArrayObject*>(arr)),
                    vals.data(), sizeof(float) * n * width);
    }
    return arr;
}

PyObject* load_measurements(PyObject*, PyObject* args, PyObject* kwargs) {
    const char* path = nullptr;
    int labeled = 0;
    static const char* kwlist[] = {"path", "labeled", nullptr};
    if (!PyArg_ParseTupleAndKeywords(args, kwargs, "s|p",
                                     const_cast<char**>(kwlist), &path,
                                     &labeled))
        return nullptr;

    FILE* fh = std::fopen(path, "r");
    if (!fh) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return nullptr;
    }

    PyObject* result = PyList_New(0);
    if (!result) { std::fclose(fh); return nullptr; }

    const int width = labeled ? 3 : 2;
    std::vector<float> vals;
    std::string line;
    char buf[1 << 16];
    bool first = true;       // header line skipped (main.cpp:231)
    bool last_empty = false;

    while (true) {
        line.clear();
        bool got = false;
        while (std::fgets(buf, sizeof(buf), fh)) {
            got = true;
            line += buf;
            if (!line.empty() && line.back() == '\n') break;
        }
        if (!got) break;
        if (first) { first = false; continue; }
        parse_line(line.c_str(), vals);
        size_t n = (vals.size() / width) * width;
        vals.resize(n);
        last_empty = vals.empty();
        PyObject* arr = make_array(vals, width);
        if (!arr || PyList_Append(result, arr) < 0) {
            Py_XDECREF(arr);
            Py_DECREF(result);
            std::fclose(fh);
            return nullptr;
        }
        Py_DECREF(arr);
    }
    std::fclose(fh);

    // trailing empty entry from the final newline dropped (main.cpp:239)
    Py_ssize_t len = PyList_GET_SIZE(result);
    if (len > 0 && last_empty) {
        if (PyList_SetSlice(result, len - 1, len, nullptr) < 0) {
            Py_DECREF(result);
            return nullptr;
        }
    }
    return result;
}

PyObject* load_controls(PyObject*, PyObject* args) {
    const char* path = nullptr;
    if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;

    FILE* fh = std::fopen(path, "r");
    if (!fh) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return nullptr;
    }
    std::vector<float> rows;
    std::vector<float> vals;
    char buf[1 << 14];
    bool first = true;
    while (std::fgets(buf, sizeof(buf), fh)) {
        if (first) { first = false; continue; }
        parse_line(buf, vals);
        if (vals.size() >= 2) {
            rows.push_back(vals[0]);
            rows.push_back(vals[1]);
        }
    }
    std::fclose(fh);
    return make_array(rows, 2);
}

// Bulk writer: join pre-formatted rows of floats as "%g"-formatted lines.
// lines: sequence of 1-D float arrays (or None -> empty line).
PyObject* write_state_lines(PyObject*, PyObject* args) {
    const char* path = nullptr;
    PyObject* lines = nullptr;
    if (!PyArg_ParseTuple(args, "sO", &path, &lines)) return nullptr;

    FILE* fh = std::fopen(path, "a");
    if (!fh) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return nullptr;
    }
    PyObject* seq = PySequence_Fast(lines, "lines must be a sequence");
    if (!seq) { std::fclose(fh); return nullptr; }

    char num[64];
    for (Py_ssize_t i = 0; i < PySequence_Fast_GET_SIZE(seq); ++i) {
        PyObject* item = PySequence_Fast_GET_ITEM(seq, i);
        if (item != Py_None) {
            PyArrayObject* arr = reinterpret_cast<PyArrayObject*>(
                PyArray_FROMANY(item, NPY_FLOAT64, 1, 1,
                                NPY_ARRAY_C_CONTIGUOUS));
            if (!arr) { Py_DECREF(seq); std::fclose(fh); return nullptr; }
            const double* data = static_cast<double*>(PyArray_DATA(arr));
            npy_intp n = PyArray_DIM(arr, 0);
            for (npy_intp j = 0; j < n; ++j) {
                int len = std::snprintf(num, sizeof(num), "%g ", data[j]);
                std::fwrite(num, 1, len, fh);
            }
            Py_DECREF(arr);
        }
        std::fputc('\n', fh);
    }
    Py_DECREF(seq);
    std::fclose(fh);
    Py_RETURN_NONE;
}

PyMethodDef methods[] = {
    {"load_measurements", reinterpret_cast<PyCFunction>(load_measurements),
     METH_VARARGS | METH_KEYWORDS,
     "Parse a measurements file into a list of [n, 2|3] float32 arrays."},
    {"load_controls", load_controls, METH_VARARGS,
     "Parse a controls file into an [N, 2] float32 array."},
    {"write_state_lines", write_state_lines, METH_VARARGS,
     "Append %g-formatted rows (None = empty line) to a log file."},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "textio",
                      "Native text IO fast path", -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit_textio(void) {
    import_array();
    return PyModule_Create(&module);
}
