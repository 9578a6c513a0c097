from repro_torch.quant.qtensor import (QTensor, matmul_impl, pack_int4,
                                       resolved_impl, set_matmul_impl,
                                       unpack_int4)

__all__ = ["QTensor", "matmul_impl", "pack_int4", "resolved_impl",
           "set_matmul_impl", "unpack_int4"]
