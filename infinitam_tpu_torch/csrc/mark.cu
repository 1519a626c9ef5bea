// The phase mark of engine/spans.py: one thread appends (phase id, frame
// sequence number, %globaltimer) to a ring on the device. Launched on the
// current stream, so under stream capture it becomes one kernel node of the
// graph, between the nodes of the phase before it and the phase after it.
#include "common.cuh"

// head[0]: marks appended so far (the ring's cursor; past `cap` the mark is
// dropped), head[1]: marks dropped, head[2]: the frame sequence number, which
// a begin mark counts on before it writes. rows: [cap, 3] int64.
__global__ void itpu_mark_kernel(unsigned long long* head, long long* rows, int cap, int phase, int begin) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    unsigned long long seq = begin ? atomicAdd(&head[2], 1ULL) + 1ULL : head[2];
    unsigned long long i = atomicAdd(&head[0], 1ULL);
    if (i < (unsigned long long)cap) {
        rows[3 * i] = phase;
        rows[3 * i + 1] = (long long)seq;
        rows[3 * i + 2] = (long long)t;
    } else {
        atomicAdd(&head[1], 1ULL);
    }
}

ITPU_EXPORT int itpu_mark(void* head, void* rows, int cap, int phase, int begin, void* stream) {
    itpu_mark_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((unsigned long long*)head, (long long*)rows, cap, phase,
                                                        begin);
    return (int)cudaGetLastError();
}
