"""Hand-written GPU kernels for the hot DSP paths (SURVEY.md §7 step 6).

Currently: the overlapped-window Viterbi decoder (viterbi_triton), Pallas
through Triton — the GPU replacement for the reference's SSE2 ACS kernel.
Modules are imported on use, so importing the package needs no kernel
backend.
"""
