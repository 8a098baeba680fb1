/* fedml_client.h — C API of the native device SDK.
 *
 * Mirrors the reference's on-device surface so a real app can bind it the
 * way the Android app binds JNI:
 *
 *   reference JNI (JniFedMLClientManager.cpp)        this C ABI
 *   ------------------------------------------       -------------------
 *   NativeFedMLClientManager_create          :15  -> fedml_client_create
 *   NativeFedMLClientManager_release         :26  -> fedml_client_release
 *   NativeFedMLClientManager_init            :43  -> fedml_client_init
 *                                                    (+ _set_callbacks)
 *   NativeFedMLClientManager_train           :103 -> fedml_client_train
 *   NativeFedMLClientManager_getEpochAndLoss :116 -> fedml_client_get_epoch_and_loss
 *   NativeFedMLClientManager_stopTraining    :129 -> fedml_client_stop_training
 *   (MNN serialized-model handling)               -> artifact_* family
 *   (on-device test/eval)                         -> fedml_client_evaluate
 *
 * Model artifacts are the framework's msgpack format ("FMTPU1\n" magic;
 * serving.save_model/load_model) — the device consumes the server's
 * global model and produces an update the server loads with no Python on
 * the device. Implementation: ../mobilenn.cpp (link the shared object the
 * package builds, libmobilenn-<hash>.so).
 */

#ifndef FEDML_TPU_NATIVE_FEDML_CLIENT_H
#define FEDML_TPU_NATIVE_FEDML_CLIENT_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ---- client manager session (FedMLClientManager analogue) ----------- */

typedef void (*fedml_progress_cb)(float pct);
typedef void (*fedml_loss_cb)(int32_t epoch, float loss);

/* Opaque session handle. */
void* fedml_client_create(void);
void  fedml_client_release(void* client);

/* Load the global model artifact and this device's CSV data shard
 * (label in the last column). Returns 0, or <0 on artifact/data errors. */
int32_t fedml_client_init(void* client, const char* model_path,
                          const char* data_path, int32_t batch_size,
                          float learning_rate, int32_t epoch_num,
                          uint64_t seed);

void fedml_client_set_callbacks(void* client, fedml_progress_cb progress,
                                fedml_loss_cb loss);

/* Run the local epochs; honors fedml_client_stop_training between
 * epochs; returns final-epoch mean loss (NaN on error). */
float fedml_client_train(void* client);

/* Most recent (epoch, loss) pair — the getEpochAndLoss analogue. */
int32_t fedml_client_get_epoch_and_loss(void* client, int32_t* epoch,
                                        float* loss);

int32_t fedml_client_stop_training(void* client);

/* On-device evaluation (accuracy in [0,1]) of the current params on the
 * loaded shard; -1 on error. */
float fedml_client_evaluate(void* client);

/* Persist the trained params as a server-loadable artifact. */
int32_t fedml_client_save_model(void* client, const char* path);

/* ---- model artifact access (serialized-model handling) -------------- */

void*   artifact_open(const char* path);            /* NULL on error   */
int32_t artifact_count(void* artifact);
int32_t artifact_key(void* artifact, int32_t i, char* out, int32_t cap);
int64_t artifact_elems(void* artifact, const char* key);  /* -1 missing */
int32_t artifact_shape(void* artifact, const char* key, int32_t* dims,
                       int32_t cap);
int64_t artifact_read_f32(void* artifact, const char* key, float* out,
                          int64_t cap);
void    artifact_close(void* artifact);
int32_t artifact_save(const char* path, const char** keys,
                      const float** data, const int32_t* ndims,
                      const int32_t* shapes, int32_t n_leaves);

/* ---- raw trainers / masking / data (see mobilenn.cpp) --------------- */

float train_linear_sgd(float* W, float* b, const float* x,
                       const int32_t* y, int32_t n, int32_t d, int32_t k,
                       int32_t epochs, int32_t batch, float lr,
                       uint64_t seed);
float eval_linear(const float* W, const float* b, const float* x,
                  const int32_t* y, int32_t n, int32_t d, int32_t k);
void gen_mask(uint32_t* out, int64_t n, uint64_t seed);
void mask_vector(uint32_t* out, const float* v, int64_t n, float scale,
                 uint64_t seed);
void unmask_vector(float* out, const uint32_t* masked, int64_t n,
                   float scale, uint64_t seed);
int32_t lsa_mask_encode(uint32_t* out, const uint32_t* z, int32_t d,
                        int32_t n_clients, int32_t privacy_t,
                        int32_t split_t, uint64_t seed);
int32_t csv_probe(const char* path, int32_t* rows, int32_t* cols);
int32_t csv_read(const char* path, float* x, int32_t* y, int32_t rows,
                 int32_t cols);
int32_t mobilenn_abi_version(void);

#ifdef __cplusplus
}
#endif

#endif /* FEDML_TPU_NATIVE_FEDML_CLIENT_H */
