// C ABI over the clarabel_tpu_torch solver (see include/clarabel_tpu.h).
//
// The port's counterpart of the JAX package's native/capi.cpp, implementing
// the same header unchanged: a C program switches between the two packages
// by linking the other library.  The reference exposes its native core
// through a thin C layer (reference: src/julia/interface.rs:55-130); here
// the core is the PyTorch solver, so this shim embeds CPython and forwards
// to clarabel_tpu_torch.capi_support, which does all object construction.
// The C++ side only moves raw buffers (as memoryviews) and plain scalars.
// The solve runs on the CUDA card unless the settings JSON carries
// "device": "cpu".
//
// Works both as a standalone embedding (C program links this library and
// no interpreter exists yet) and loaded inside an existing Python process
// (ctypes) — every entry point brackets with PyGILState_Ensure/Release and
// initialization is skipped when an interpreter is already running.
//
// Built by clarabel_tpu_torch.capi_support.build_library() with g++ and the
// interpreter's embedding flags, into build/clarabel_tpu_torch/.

#include <Python.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

#include "clarabel_tpu.h"

namespace {

thread_local std::string g_last_error;

void set_error_from_python() {
    PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
    PyErr_Fetch(&type, &value, &tb);
    PyErr_NormalizeException(&type, &value, &tb);
    g_last_error = "python error";
    if (value) {
        if (PyObject *s = PyObject_Str(value)) {
            if (const char *c = PyUnicode_AsUTF8(s)) g_last_error = c;
            Py_DECREF(s);
        }
    }
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(tb);
}

// Initialize an interpreter if none exists (standalone C callers).  The
// package root comes from $CLARABEL_TPU_PYROOT or the compile-time
// default; $PYTHONPATH entries are kept.
bool ensure_python() {
    if (Py_IsInitialized()) return true;
    Py_InitializeEx(0);  // no signal handlers: we are a guest
    if (!Py_IsInitialized()) {
        g_last_error = "failed to initialize CPython";
        return false;
    }
    const char *root = getenv("CLARABEL_TPU_PYROOT");
#ifdef CLARABEL_TPU_ROOT
    if (!root || !*root) root = CLARABEL_TPU_ROOT;
#endif
    if (root && *root) {
        PyObject *sys_path = PySys_GetObject("path");  // borrowed
        PyObject *p = PyUnicode_FromString(root);
        if (sys_path && p) PyList_Insert(sys_path, 0, p);
        Py_XDECREF(p);
    }
    // the embedded interpreter must release the GIL so PyGILState_Ensure
    // works uniformly from any thread afterwards
    PyEval_SaveThread();
    return true;
}

PyObject *support_fn(const char *name) {
    PyObject *mod = PyImport_ImportModule("clarabel_tpu_torch.capi_support");
    if (!mod) return nullptr;
    PyObject *fn = PyObject_GetAttrString(mod, name);
    Py_DECREF(mod);
    return fn;
}

PyObject *mv_ro(const void *p, Py_ssize_t nbytes) {
    return PyMemoryView_FromMemory(
        const_cast<char *>(static_cast<const char *>(p)), nbytes, PyBUF_READ);
}

PyObject *mv_rw(void *p, Py_ssize_t nbytes) {
    return PyMemoryView_FromMemory(static_cast<char *>(p), nbytes,
                                   PyBUF_WRITE);
}

struct GIL {
    PyGILState_STATE st;
    GIL() : st(PyGILState_Ensure()) {}
    ~GIL() { PyGILState_Release(st); }
};

// --- termination callback trampoline -------------------------------------
// The Python side calls this PyCFunction once per IPM iteration with the
// in-progress info scalars; it forwards to the user's C fn-ptr + user_data
// (reference: callbacks.rs:7-97 — the C callback variant with a Mutex'd
// user-data pointer; here the capsule plays that role).

struct CallbackData {
    clarabel_termination_callback fn;
    void *user_data;
};

void cb_capsule_destructor(PyObject *capsule) {
    delete static_cast<CallbackData *>(
        PyCapsule_GetPointer(capsule, "clarabel_cb"));
}

PyObject *cb_trampoline(PyObject *self, PyObject *args) {
    CallbackData *cd =
        static_cast<CallbackData *>(PyCapsule_GetPointer(self, "clarabel_cb"));
    if (!cd) return nullptr;
    int iterations = 0;
    double obj = 0, obj_dual = 0, rp = 0, rd = 0, elapsed = 0;
    if (!PyArg_ParseTuple(args, "iddddd", &iterations, &obj, &obj_dual, &rp,
                          &rd, &elapsed))
        return nullptr;
    clarabel_info info;
    info.status = CLARABEL_UNSOLVED;  // in progress
    info.iterations = iterations;
    info.obj_val = obj;
    info.obj_val_dual = obj_dual;
    info.solve_time = elapsed;
    info.r_prim = rp;
    info.r_dual = rd;
    int32_t stop = 0;
    Py_BEGIN_ALLOW_THREADS
    stop = cd->fn(&info, cd->user_data);
    Py_END_ALLOW_THREADS
    return PyBool_FromLong(stop != 0);
}

PyMethodDef cb_method_def = {"clarabel_cb_trampoline", cb_trampoline,
                             METH_VARARGS, nullptr};

}  // namespace

extern "C" {

const char *clarabel_last_error(void) { return g_last_error.c_str(); }

void *clarabel_new(int64_t n, int64_t m, const int64_t *Pp, const int64_t *Pi,
                   const double *Px, const double *q, const int64_t *Ap,
                   const int64_t *Ai, const double *Ax, const double *b,
                   const clarabel_cone *cones, int64_t ncones,
                   const char *settings_json) {
    g_last_error.clear();
    if (!ensure_python()) return nullptr;
    GIL gil;

    int64_t p_nnz = Pp[n];
    int64_t a_nnz = Ap[n];

    PyObject *cone_list = PyList_New(ncones);
    if (!cone_list) {
        set_error_from_python();
        return nullptr;
    }
    for (int64_t i = 0; i < ncones; ++i) {
        const clarabel_cone &c = cones[i];
        PyObject *alpha;
        if (c.alpha && c.nalpha > 0) {
            alpha = PyTuple_New(c.nalpha);
            for (int64_t j = 0; j < c.nalpha; ++j)
                PyTuple_SET_ITEM(alpha, j, PyFloat_FromDouble(c.alpha[j]));
        } else {
            alpha = Py_None;
            Py_INCREF(Py_None);
        }
        PyObject *rec = Py_BuildValue("(iLdN)", (int)c.tag, (long long)c.dim,
                                      c.power, alpha);
        PyList_SET_ITEM(cone_list, i, rec);
    }

    PyObject *fn = support_fn("new_solver");
    if (!fn) {
        set_error_from_python();
        Py_DECREF(cone_list);
        return nullptr;
    }
    PyObject *args = Py_BuildValue(
        "(LLNNNNNNNNNs)", (long long)n, (long long)m,
        mv_ro(Pp, (n + 1) * 8), mv_ro(Pi, p_nnz * 8), mv_ro(Px, p_nnz * 8),
        mv_ro(q, n * 8), mv_ro(Ap, (n + 1) * 8), mv_ro(Ai, a_nnz * 8),
        mv_ro(Ax, a_nnz * 8), mv_ro(b, m * 8), cone_list,
        settings_json ? settings_json : "");
    PyObject *solver = args ? PyObject_CallObject(fn, args) : nullptr;
    Py_XDECREF(args);
    Py_DECREF(fn);
    if (!solver) {
        set_error_from_python();
        return nullptr;
    }
    return solver;  // owned reference IS the handle
}

int32_t clarabel_solve(void *handle, double *x, double *z, double *s,
                       clarabel_info *info) {
    g_last_error.clear();
    if (!handle) {
        g_last_error = "null handle";
        return -1;
    }
    GIL gil;
    PyObject *solver = static_cast<PyObject *>(handle);

    // user-frame buffer sizes (Handle.n / Handle.m): x[n], z[m], s[m]
    PyObject *n_attr = PyObject_GetAttrString(solver, "n");
    PyObject *m_attr = PyObject_GetAttrString(solver, "m");
    int64_t n = n_attr ? PyLong_AsLongLong(n_attr) : -1;
    int64_t m = m_attr ? PyLong_AsLongLong(m_attr) : -1;
    Py_XDECREF(n_attr);
    Py_XDECREF(m_attr);
    if (n < 0 || m < 0) {
        PyErr_Clear();
        g_last_error = "could not read problem dimensions from handle";
        return -1;
    }

    // scratch for skipped outputs
    std::string xbuf, zbuf, sbuf;
    if (!x) { xbuf.resize(n * 8); x = reinterpret_cast<double *>(&xbuf[0]); }
    if (!z) { zbuf.resize(m * 8); z = reinterpret_cast<double *>(&zbuf[0]); }
    if (!s) { sbuf.resize(m * 8); s = reinterpret_cast<double *>(&sbuf[0]); }

    PyObject *fn = support_fn("solve_into");
    if (!fn) {
        set_error_from_python();
        return -1;
    }
    PyObject *res = PyObject_CallFunction(
        fn, "ONNN", solver, mv_rw(x, n * 8), mv_rw(z, m * 8), mv_rw(s, m * 8));
    Py_DECREF(fn);
    if (!res) {
        set_error_from_python();
        return -1;
    }
    int status = -1, iterations = 0;
    double obj = 0, obj_dual = 0, t = 0, rp = 0, rd = 0;
    if (!PyArg_ParseTuple(res, "idddidd", &status, &obj, &obj_dual, &t,
                          &iterations, &rp, &rd)) {
        set_error_from_python();
        Py_DECREF(res);
        return -1;
    }
    Py_DECREF(res);
    if (info) {
        info->status = status;
        info->iterations = iterations;
        info->obj_val = obj;
        info->obj_val_dual = obj_dual;
        info->solve_time = t;
        info->r_prim = rp;
        info->r_dual = rd;
    }
    return status;
}

int32_t clarabel_update(void *handle, const char *which, const double *vals,
                        int64_t len) {
    g_last_error.clear();
    if (!handle || !which) {
        g_last_error = "null argument";
        return -1;
    }
    GIL gil;
    PyObject *fn = support_fn("update");
    if (!fn) {
        set_error_from_python();
        return -1;
    }
    PyObject *res = PyObject_CallFunction(fn, "OsN",
                                          static_cast<PyObject *>(handle),
                                          which, mv_ro(vals, len * 8));
    Py_DECREF(fn);
    if (!res) {
        set_error_from_python();
        return -1;
    }
    Py_DECREF(res);
    return 0;
}

int32_t clarabel_set_termination_callback(void *handle,
                                          clarabel_termination_callback cb,
                                          void *user_data) {
    g_last_error.clear();
    if (!handle) {
        g_last_error = "null handle";
        return -1;
    }
    GIL gil;
    if (!cb) {
        PyObject *fn = support_fn("unset_termination_callback");
        if (!fn) {
            set_error_from_python();
            return -1;
        }
        PyObject *res =
            PyObject_CallFunction(fn, "O", static_cast<PyObject *>(handle));
        Py_DECREF(fn);
        if (!res) {
            set_error_from_python();
            return -1;
        }
        Py_DECREF(res);
        return 0;
    }
    CallbackData *cd = new CallbackData{cb, user_data};
    PyObject *capsule = PyCapsule_New(cd, "clarabel_cb", cb_capsule_destructor);
    if (!capsule) {
        delete cd;
        set_error_from_python();
        return -1;
    }
    PyObject *callable = PyCFunction_New(&cb_method_def, capsule);
    Py_DECREF(capsule);  // the PyCFunction holds its own reference
    if (!callable) {
        set_error_from_python();
        return -1;
    }
    PyObject *fn = support_fn("set_termination_callback_c");
    if (!fn) {
        Py_DECREF(callable);
        set_error_from_python();
        return -1;
    }
    PyObject *res = PyObject_CallFunction(
        fn, "ON", static_cast<PyObject *>(handle), callable);
    Py_DECREF(fn);
    if (!res) {
        set_error_from_python();
        return -1;
    }
    Py_DECREF(res);
    return 0;
}

int64_t clarabel_iteration_history_len(void *handle) {
    g_last_error.clear();
    if (!handle) {
        g_last_error = "null handle";
        return -1;
    }
    GIL gil;
    PyObject *fn = support_fn("iteration_history_len");
    if (!fn) {
        set_error_from_python();
        return -1;
    }
    PyObject *res =
        PyObject_CallFunction(fn, "O", static_cast<PyObject *>(handle));
    Py_DECREF(fn);
    if (!res) {
        set_error_from_python();
        return -1;
    }
    int64_t out = PyLong_AsLongLong(res);
    Py_DECREF(res);
    if (out == -1 && PyErr_Occurred()) {
        set_error_from_python();
        return -1;
    }
    return out;
}

int64_t clarabel_iteration_history(void *handle, double *out,
                                   int64_t max_rows) {
    g_last_error.clear();
    if (!handle || !out) {
        g_last_error = "null argument";
        return -1;
    }
    GIL gil;
    PyObject *fn = support_fn("iteration_history_into");
    if (!fn) {
        set_error_from_python();
        return -1;
    }
    PyObject *res = PyObject_CallFunction(
        fn, "ONL", static_cast<PyObject *>(handle),
        mv_rw(out, max_rows * 9 * 8), (long long)max_rows);
    Py_DECREF(fn);
    if (!res) {
        set_error_from_python();
        return -1;
    }
    int64_t rows = PyLong_AsLongLong(res);
    Py_DECREF(res);
    if (rows == -1 && PyErr_Occurred()) {
        set_error_from_python();
        return -1;
    }
    return rows;
}

void clarabel_print_timers(void *handle) {
    if (!handle) return;
    GIL gil;
    PyObject *fn = support_fn("print_timers");
    if (!fn) {
        PyErr_Clear();
        return;
    }
    PyObject *res =
        PyObject_CallFunction(fn, "O", static_cast<PyObject *>(handle));
    Py_DECREF(fn);
    if (!res) PyErr_Clear();
    Py_XDECREF(res);
}

void clarabel_free(void *handle) {
    if (!handle) return;
    GIL gil;
    Py_DECREF(static_cast<PyObject *>(handle));
}

}  // extern "C"
