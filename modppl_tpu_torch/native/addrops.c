/* _addrops: the port's address layer in C (counterpart of
 * modppl_tpu/native/addrops.c).
 *
 * Every sample site of every eager GFI call splits, normalizes and hashes
 * its address string; this module does it without interpreter dispatch and
 * memoizes each raw string's (normalized, components, hash).
 *
 * Exposes:
 *   split_addr(s)      -> (term,) | (first, rest)
 *   normalize_addr(s)  -> canonical " / "-joined form
 *   addr_components(s) -> tuple of trimmed components
 *   addr_hash(s)       -> 31-bit FNV-1a of the UTF-8 normalized address
 *   lookup(s)          -> (normalized, components, hash), memoized
 *   cache_size()       -> number of memoized addresses
 *
 * The rules are those of the pure-Python functions in
 * modppl_tpu_torch/core/address.py, which the port's lane keys hash
 * (fold_in_lanes(keys, addr_hash(addr))), so they must agree bitwise
 * (tests/test_torch_native.py holds them so on generated addresses):
 *
 * - the split is the regex ^(.*?)/(.*)$ of the Python path: at the first
 *   '/', unless a '\n' precedes it, or one follows it anywhere but as the
 *   string's last character (then the address is one term); a final '\n'
 *   is dropped from the rest, as the regex's '$' leaves it out;
 * - components are trimmed as str.strip() trims: Py_UNICODE_ISSPACE on
 *   code points, not only ASCII whitespace.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

static PyObject *cache = NULL; /* raw string -> (normalized, comps, hash) */

/* s[a:b] with str.strip()'s whitespace trimmed; a new reference */
static PyObject *strip_range(PyObject *s, Py_ssize_t a, Py_ssize_t b)
{
    int kind = PyUnicode_KIND(s);
    const void *data = PyUnicode_DATA(s);
    while (a < b && Py_UNICODE_ISSPACE(PyUnicode_READ(kind, data, a)))
        a++;
    while (b > a && Py_UNICODE_ISSPACE(PyUnicode_READ(kind, data, b - 1)))
        b--;
    return PyUnicode_Substring(s, a, b);
}

/* The Python path's split. Returns 1 and sets *first (trimmed) and *rest
 * (new references) at a split, 0 and sets *first (the trimmed term) for a
 * single term, -1 on error. */
static int split_rule(PyObject *s, PyObject **first, PyObject **rest)
{
    Py_ssize_t n = PyUnicode_GET_LENGTH(s);
    Py_ssize_t p = PyUnicode_FindChar(s, '/', 0, n, 1);
    if (p == -2)
        return -1;
    int split = p >= 0;
    if (split) {
        Py_ssize_t nl = PyUnicode_FindChar(s, '\n', 0, p, 1);
        if (nl == -2)
            return -1;
        if (nl >= 0)
            split = 0;
    }
    Py_ssize_t end = n;
    if (split && n - 1 > p) {
        Py_ssize_t nl = PyUnicode_FindChar(s, '\n', p + 1, n - 1, 1);
        if (nl == -2)
            return -1;
        if (nl >= 0)
            split = 0;
        else if (PyUnicode_READ_CHAR(s, n - 1) == '\n')
            end = n - 1;
    }
    if (!split) {
        *first = strip_range(s, 0, n);
        *rest = NULL;
        return *first ? 0 : -1;
    }
    *first = strip_range(s, 0, p);
    if (!*first)
        return -1;
    *rest = PyUnicode_Substring(s, p + 1, end);
    if (!*rest) {
        Py_CLEAR(*first);
        return -1;
    }
    return 1;
}

static unsigned long fnv1a31(const char *s, Py_ssize_t len)
{
    unsigned long h = 2166136261UL;
    for (Py_ssize_t i = 0; i < len; i++) {
        h ^= (unsigned char)s[i];
        h = (h * 16777619UL) & 0xFFFFFFFFUL;
    }
    return h & 0x7FFFFFFFUL;
}

/* (normalized, components, hash) of a str, memoized; a new reference */
static PyObject *entry_for(PyObject *arg)
{
    PyObject *hit = PyDict_GetItemWithError(cache, arg); /* borrowed */
    if (hit) {
        Py_INCREF(hit);
        return hit;
    }
    if (PyErr_Occurred())
        return NULL;

    PyObject *comps = PyList_New(0);
    if (!comps)
        return NULL;
    PyObject *cur = arg;
    Py_INCREF(cur);
    for (;;) {
        PyObject *first, *rest;
        int r = split_rule(cur, &first, &rest);
        Py_DECREF(cur);
        if (r < 0) {
            Py_DECREF(comps);
            return NULL;
        }
        int ok = PyList_Append(comps, first);
        Py_DECREF(first);
        if (ok < 0) {
            Py_XDECREF(rest);
            Py_DECREF(comps);
            return NULL;
        }
        if (r == 0)
            break;
        cur = rest;
    }

    PyObject *entry = NULL, *norm = NULL, *ctuple = NULL, *h = NULL;
    PyObject *sep = PyUnicode_FromString(" / ");
    if (!sep)
        goto done;
    norm = PyUnicode_Join(sep, comps);
    Py_DECREF(sep);
    if (!norm)
        goto done;
    ctuple = PyList_AsTuple(comps);
    if (!ctuple)
        goto done;
    Py_ssize_t nlen;
    const char *ns = PyUnicode_AsUTF8AndSize(norm, &nlen);
    if (!ns)
        goto done;
    h = PyLong_FromUnsignedLong(fnv1a31(ns, nlen));
    if (!h)
        goto done;
    entry = PyTuple_Pack(3, norm, ctuple, h);
    if (entry && PyDict_SetItem(cache, arg, entry) < 0)
        Py_CLEAR(entry);
done:
    Py_DECREF(comps);
    Py_XDECREF(norm);
    Py_XDECREF(ctuple);
    Py_XDECREF(h);
    return entry;
}

static int check_str(PyObject *arg, const char *what)
{
    if (!PyUnicode_Check(arg)) {
        PyErr_Format(PyExc_TypeError, "%s: address must be str", what);
        return -1;
    }
    return 0;
}

static PyObject *py_lookup(PyObject *self, PyObject *arg)
{
    if (check_str(arg, "lookup") < 0)
        return NULL;
    return entry_for(arg);
}

static PyObject *entry_item(PyObject *arg, Py_ssize_t i, const char *what)
{
    if (check_str(arg, what) < 0)
        return NULL;
    PyObject *e = entry_for(arg);
    if (!e)
        return NULL;
    PyObject *r = PyTuple_GET_ITEM(e, i);
    Py_INCREF(r);
    Py_DECREF(e);
    return r;
}

static PyObject *py_normalize(PyObject *self, PyObject *arg)
{
    return entry_item(arg, 0, "normalize_addr");
}

static PyObject *py_components(PyObject *self, PyObject *arg)
{
    return entry_item(arg, 1, "addr_components");
}

static PyObject *py_hash(PyObject *self, PyObject *arg)
{
    return entry_item(arg, 2, "addr_hash");
}

static PyObject *py_split(PyObject *self, PyObject *arg)
{
    if (check_str(arg, "split_addr") < 0)
        return NULL;
    PyObject *first, *rest;
    int r = split_rule(arg, &first, &rest);
    if (r < 0)
        return NULL;
    PyObject *out = r ? PyTuple_Pack(2, first, rest)
                      : PyTuple_Pack(1, first);
    Py_DECREF(first);
    Py_XDECREF(rest);
    return out;
}

static PyObject *py_cache_size(PyObject *self, PyObject *noarg)
{
    return PyLong_FromSsize_t(PyDict_Size(cache));
}

static PyMethodDef methods[] = {
    {"lookup", py_lookup, METH_O,
     "lookup(addr) -> (normalized, components, hash31), memoized"},
    {"normalize_addr", py_normalize, METH_O, "canonical ' / ' form"},
    {"addr_components", py_components, METH_O, "tuple of trimmed components"},
    {"addr_hash", py_hash, METH_O, "31-bit FNV-1a of the normalized address"},
    {"split_addr", py_split, METH_O, "(term,) or (first, rest)"},
    {"cache_size", py_cache_size, METH_NOARGS, "memoized addresses"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_addrops",
    "the address layer of modppl_tpu_torch in C", -1, methods,
};

PyMODINIT_FUNC PyInit__addrops(void)
{
    PyObject *m = PyModule_Create(&moduledef);
    if (!m)
        return NULL;
    cache = PyDict_New();
    if (!cache) {
        Py_DECREF(m);
        return NULL;
    }
    return m;
}
