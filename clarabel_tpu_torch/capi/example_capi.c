/* Standalone C driver for the clarabel_tpu_torch C ABI.
 *
 * The port's counterpart of examples/example_capi.c: the same program over
 * the same header (include/clarabel_tpu.h), linked against the port's shim.
 * Solves the reference's basic QP (tests/basic_qp.rs):
 *     min  x'Px/2 + q'x   s.t.  x >= 0, x1+x2 <= 1, x <= 0.7
 * on the device named by the first argument ("cuda" by default, or "cpu"),
 * which travels in the settings JSON's "device" key.
 * Build (from the repo root):
 *     lib=$(python3 -m clarabel_tpu_torch.capi_support)
 *     gcc -O2 -Iinclude clarabel_tpu_torch/capi/example_capi.c "$lib" \
 *         -o example_capi
 *     ./example_capi cuda
 */
#include <stdio.h>
#include <string.h>

#include "clarabel_tpu.h"

static int32_t stop_after_one(const clarabel_info *info, void *user_data) {
    int *count = (int *)user_data;
    ++*count;
    return info->iterations >= 1;
}

int main(int argc, char **argv) {
    const char *device = argc > 1 ? argv[1] : "cuda";
    if (strcmp(device, "cuda") != 0 && strcmp(device, "cpu") != 0) {
        fprintf(stderr, "usage: %s [cuda|cpu]\n", argv[0]);
        return 1;
    }
    char settings[64];
    snprintf(settings, sizeof settings, "{\"verbose\": false, \"device\": \"%s\"}",
             device);

    /* P (upper triangle), CSC */
    int64_t Pp[] = {0, 1, 3};
    int64_t Pi[] = {0, 0, 1};
    double Px[] = {4.0, 1.0, 2.0};
    double q[] = {1.0, 1.0};
    /* A (6x2) = [-A1; A1] with A1 = [1 1; 1 0; 0 1], CSC */
    int64_t Ap[] = {0, 4, 8};
    int64_t Ai[] = {0, 1, 3, 4, 0, 2, 3, 5};
    double Ax[] = {-1.0, -1.0, 1.0, 1.0, -1.0, -1.0, 1.0, 1.0};
    double b[] = {-1.0, 0.0, 0.0, 1.0, 0.7, 0.7};

    clarabel_cone cones[2] = {{CLARABEL_NONNEGATIVE_CONE, 3, 0.0, 0, 0},
                              {CLARABEL_NONNEGATIVE_CONE, 3, 0.0, 0, 0}};

    void *solver = clarabel_new(2, 6, Pp, Pi, Px, q, Ap, Ai, Ax, b, cones, 2,
                                settings);
    if (!solver) {
        fprintf(stderr, "solver_new failed: %s\n", clarabel_last_error());
        return 1;
    }

    double x[2], z[6], s[6];
    clarabel_info info;
    int32_t status = clarabel_solve(solver, x, z, s, &info);
    if (status < 0) {
        fprintf(stderr, "solve failed: %s\n", clarabel_last_error());
        clarabel_free(solver);
        return 1;
    }
    printf("status=%d obj=%.6g x=(%.4f, %.4f) iters=%d\n", status,
           info.obj_val, x[0], x[1], info.iterations);
    if (status != CLARABEL_SOLVED) {
        clarabel_free(solver);
        return 2;
    }

    /* termination callback: cancel the next solve after one iteration */
    int count = 0;
    clarabel_set_termination_callback(solver, stop_after_one, &count);
    status = clarabel_solve(solver, x, z, s, &info);
    printf("callback status=%d after %d checks\n", status, count);
    clarabel_free(solver);
    return status == CLARABEL_CALLBACK_TERMINATED ? 0 : 3;
}
