"""Plain float64 references of what the cells compute. They import
nothing of the program (``chowdsp_fft_tpu_torch``) nor of the JAX
package, and take nothing the program made: the benchmark hands them the
same inputs it hands the program."""
