"""The ``-Xptxas -v`` reports of the port's three kernel libraries as nvcc
12.9 printed them for ``sm_90a`` (``chip_smoke.py`` phase 1 on an NVIDIA
H100 80GB HBM3, 700.00 W; the compile-time lines left out): fixed inputs
for the CPU tests of the Hopper launch checker."""

REPORTS = {
    "dfg_count": """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__8d1744ca_12_dfg_count_cu_8b36e46716dfg_count_kernelILb1ELb1ENS_9HashTableEEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__8d1744ca_12_dfg_count_cu_8b36e46716dfg_count_kernelILb1ELb1ENS_9HashTableEEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 44 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__8d1744ca_12_dfg_count_cu_8b36e46716dfg_count_kernelILb1ELb0ENS_9HashTableEEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__8d1744ca_12_dfg_count_cu_8b36e46716dfg_count_kernelILb1ELb0ENS_9HashTableEEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 43 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__8d1744ca_12_dfg_count_cu_8b36e46716dfg_count_kernelILb0ELb1ENS_9HashTableEEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__8d1744ca_12_dfg_count_cu_8b36e46716dfg_count_kernelILb0ELb1ENS_9HashTableEEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 47 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__8d1744ca_12_dfg_count_cu_8b36e46716dfg_count_kernelILb0ELb0ENS_9HashTableEEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__8d1744ca_12_dfg_count_cu_8b36e46716dfg_count_kernelILb0ELb0ENS_9HashTableEEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__8d1744ca_12_dfg_count_cu_8b36e46716dfg_count_kernelILb1ELb1ENS_10DenseTableEEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__8d1744ca_12_dfg_count_cu_8b36e46716dfg_count_kernelILb1ELb1ENS_10DenseTableEEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__8d1744ca_12_dfg_count_cu_8b36e46716dfg_count_kernelILb1ELb0ENS_10DenseTableEEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__8d1744ca_12_dfg_count_cu_8b36e46716dfg_count_kernelILb1ELb0ENS_10DenseTableEEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 44 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__8d1744ca_12_dfg_count_cu_8b36e46716dfg_count_kernelILb0ELb1ENS_10DenseTableEEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__8d1744ca_12_dfg_count_cu_8b36e46716dfg_count_kernelILb0ELb1ENS_10DenseTableEEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__8d1744ca_12_dfg_count_cu_8b36e46716dfg_count_kernelILb0ELb0ENS_10DenseTableEEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__8d1744ca_12_dfg_count_cu_8b36e46716dfg_count_kernelILb0ELb0ENS_10DenseTableEEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers
""",
    "segment_count": """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__67361d1d_16_segment_count_cu_41b9474220segment_count_kernelILb1ELb1EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN49_GLOBAL__N__67361d1d_16_segment_count_cu_41b9474220segment_count_kernelILb1ELb1EEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 39 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__67361d1d_16_segment_count_cu_41b9474220segment_count_kernelILb0ELb1EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN49_GLOBAL__N__67361d1d_16_segment_count_cu_41b9474220segment_count_kernelILb0ELb1EEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 38 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__67361d1d_16_segment_count_cu_41b9474220segment_count_kernelILb1ELb0EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN49_GLOBAL__N__67361d1d_16_segment_count_cu_41b9474220segment_count_kernelILb1ELb0EEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 44 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__67361d1d_16_segment_count_cu_41b9474220segment_count_kernelILb0ELb0EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN49_GLOBAL__N__67361d1d_16_segment_count_cu_41b9474220segment_count_kernelILb0ELb0EEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 42 registers, used 0 barriers
""",
    "align_dp": """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__78c4a1b8_11_align_dp_cu_c3cad17415align_dp_memoryILb0EEEvPKiPKxxPKfiS6_S6_PfPyS7_' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__78c4a1b8_11_align_dp_cu_c3cad17415align_dp_memoryILb0EEEvPKiPKxxPKfiS6_S6_PfPyS7_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__78c4a1b8_11_align_dp_cu_c3cad17415align_dp_memoryILb1EEEvPKiPKxxPKfiS6_S6_PfPyS7_' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__78c4a1b8_11_align_dp_cu_c3cad17415align_dp_memoryILb1EEEvPKiPKxxPKfiS6_S6_PfPyS7_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__78c4a1b8_11_align_dp_cu_c3cad17418align_dp_registersILi32ELi20EEEvPKiPKxxPKfiS6_S6_PfPyS7_' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__78c4a1b8_11_align_dp_cu_c3cad17418align_dp_registersILi32ELi20EEEvPKiPKxxPKfiS6_S6_PfPyS7_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 124 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__78c4a1b8_11_align_dp_cu_c3cad17418align_dp_registersILi20ELi16EEEvPKiPKxxPKfiS6_S6_PfPyS7_' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__78c4a1b8_11_align_dp_cu_c3cad17418align_dp_registersILi20ELi16EEEvPKiPKxxPKfiS6_S6_PfPyS7_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 70 registers, used 0 barriers
""",
}
