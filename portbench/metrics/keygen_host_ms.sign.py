"""Host ms a call inside the program's span ``fct.keygen``
(``lifecycle.keygen``) outside its ``fct.sample`` (the host sampler, which
``sampler_ms.sign`` reads): the CPython re-seed, the coefficients' copy to
the card, the keygen NTT and vk = A.sk as the host issues them."""
from portbench.program_spans import host_ms_less


def read(trace):
    return host_ms_less(trace, "fct.keygen", "fct.sample")
