/* paddle_tpu C inference API.
 *
 * Role parity: paddle/fluid/inference/capi_exp/pd_inference_api.h — the
 * reference exposes its AnalysisPredictor to C (and Go) via a stable C
 * ABI; this header exposes the paddle_tpu AOT XLA predictor the same way.
 * The implementation (capi.cc) embeds CPython and drives
 * paddle_tpu.inference.capi_bridge; a C program only needs this header,
 * libpaddle_tpu_capi.so, and PYTHONPATH pointing at the package.
 *
 * All functions are thread-safe (the implementation takes the GIL).
 * Errors: functions returning int use >=0 success / <0 failure; the
 * message for the most recent failure on the calling thread is available
 * via PD_LastError().
 */
#ifndef PADDLE_TPU_CAPI_H_
#define PADDLE_TPU_CAPI_H_

#include <stdint.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

/* dtype codes — match paddle_tpu.inference.DataType */
enum PD_DataType {
  PD_FLOAT32 = 0,
  PD_INT64 = 1,
  PD_INT32 = 2,
  PD_UINT8 = 3,
  PD_INT8 = 4,
  PD_FLOAT16 = 5,
  PD_BFLOAT16 = 6,
  PD_BOOL = 7,
};

#define PD_MAX_NDIM 8

/* A host tensor. For inputs the caller owns `data`; for outputs filled by
 * PD_PredictorRun the library mallocs `data` — release the batch with
 * PD_ReleaseOutputs. */
typedef struct {
  int32_t dtype;               /* PD_DataType */
  int32_t ndim;                /* <= PD_MAX_NDIM */
  int64_t shape[PD_MAX_NDIM];
  void *data;
  int64_t nbytes;
} PD_TensorData;

/* Load an inference model saved by paddle_tpu (save_inference_model /
 * jit.save path prefix). Returns a handle > 0, or < 0 on failure. */
int PD_PredictorCreate(const char *path_prefix);

/* Number of feed / fetch tensors, or < 0 on bad handle. */
int PD_PredictorInputNum(int handle);
int PD_PredictorOutputNum(int handle);

/* Copy the idx-th feed/fetch name into buf (NUL-terminated, truncated to
 * buflen). Returns name length or < 0. */
int PD_PredictorInputName(int handle, int idx, char *buf, size_t buflen);
int PD_PredictorOutputName(int handle, int idx, char *buf, size_t buflen);

/* Run the program on n_in inputs (feed order). Fills `outputs` with
 * malloc'd results; returns the number of outputs produced, or < 0 on
 * failure — including when the model produces more than max_out outputs
 * (nothing is filled in that case). */
int PD_PredictorRun(int handle, const PD_TensorData *inputs, int n_in,
                    PD_TensorData *outputs, int max_out);

/* Free the data buffers of `n` outputs filled by PD_PredictorRun. */
void PD_ReleaseOutputs(PD_TensorData *outputs, int n);

/* Destroy a predictor. Returns 0/1, or < 0 on bad handle. */
int PD_PredictorDestroy(int handle);

/* Message for the most recent error on this thread ("" if none). The
 * pointer is valid until the next failing call on the same thread. */
const char *PD_LastError(void);

#ifdef __cplusplus
} /* extern "C" */
#endif

#endif /* PADDLE_TPU_CAPI_H_ */
