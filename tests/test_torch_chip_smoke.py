"""The build checks of ``chip_smoke.py`` that read ptxas's log, fed lines in
the form ptxas prints them (kernels in an anonymous namespace appear under
their mangled names)."""

import pytest

import chip_smoke

DQ = "flash_bwd_sm90_d64_dq_kernel"
DKV = "flash_bwd_sm90_d64_dkv_kernel"
PREFIX = "_ZN39_GLOBAL__N__bfd3e_21_flash_bwd_sm90_d64_cu_9cf6085828"
ENTRY_DQ = (f"ptxas info    : Compiling entry function '{PREFIX}{DQ}E14CUtensorMap_stS0_S0_S0_PKfS2_"
            f"P13__nv_bfloat16PKiiiiiff' for 'sm_90a'")
ENTRY_DKV = ENTRY_DQ.replace(f"28{DQ}", f"29{DKV}")
SERIALISED = ("ptxas warning : (C7513) Potential Performance Loss: wgmma.mma_async instructions "
              "are serialized due to non wgmma instructions defining input registers of a wgmma "
              "between start and end of the pipeline stage in the function '{}'")
# as ptxas printed it for the dk/dv kernel built with 128-query tiles
SHORT_OF_REGISTERS = (
    "ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async instructions are "
    "serialized due to insufficient register resources for the function '_ZN54_GLOBAL__N__"
    "fd013390_21_flash_bwd_sm90_d64_cu_9cf6085829flash_bwd_sm90_d64_dkv_kernelE14CUtensorMap_st"
    "S0_S0_S0_PKfS2_P13__nv_bfloat16S4_PKiiiiff'")
REGISTERS = ("ptxas info    : Used 168 registers, used 2 barriers, 448 bytes cmem[0]\n"
             "ptxas info    : 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")


@pytest.mark.parametrize("log, expected", [
    (f"{ENTRY_DQ}\n{REGISTERS}\n{ENTRY_DKV}\n{REGISTERS}", []),
    (f"{ENTRY_DKV}\n" + SERIALISED.format(f"{PREFIX}{DQ}E14CUtensorMap_st"), [DQ]),
    (f"{ENTRY_DQ}\n{REGISTERS}\n{ENTRY_DKV}\n" + SERIALISED.format("?"), [DKV]),
    (SERIALISED.format("?") + f"\n{ENTRY_DQ}", ["unattributed"]),
    (f"{ENTRY_DQ}\n{REGISTERS}\n{SHORT_OF_REGISTERS}\n{REGISTERS}", [DKV]),
    (ENTRY_DQ.replace(f"28{DQ}", "14scale_q_kernel") + "\n" + SERIALISED.format("?"),
     ["unattributed"]),
], ids=["clean", "named_mangled", "entry_function", "before_any_entry", "registers_short",
        "other_kernel"])
def test_serialised_wgmma_attributes_mangled_names(log, expected):
    """Every line saying ptxas serialised the wgmma (C7512, C7513) is caught
    and put down to the kernel whose mangled name it holds, else the entry
    function being compiled; one that names neither still counts, so the
    build fails on any."""
    hits = chip_smoke.serialised_wgmma(log, (DQ, DKV))
    assert [kernel for kernel, _ in hits] == expected
    assert all("serialized" in line for _, line in hits)


W8A8 = "w8a8_gemm_sm90_kernel"
# as ptxas printed it for the GEMM kernel whose consumer loop could leave
# its last chunk without waiting for the products
INJECTED_WAIT = (
    "ptxas info    : (C7517) warpgroup.wait is injected in around line 1586 by compiler to allow "
    "use of registers defined by GMMA in function '_ZN39_GLOBAL__N__87a74225_7_w8a8_cu_vap_w8a821"
    "w8a8_gemm_sm90_kernelE14CUtensorMap_stS0_S0_PKfS2_S2_iiii'")


def test_injected_wait_in_a_gemm_kernel_fails_the_build():
    """ptxas's C7517 (a wait it injected because registers a wgmma defines are
    read before the products are waited for) is a C751x line too: caught and
    put down to the GEMM kernel it names."""
    hits = chip_smoke.serialised_wgmma(f"{INJECTED_WAIT}\n{REGISTERS}", (W8A8,))
    assert [kernel for kernel, _ in hits] == [W8A8]


@pytest.mark.parametrize("kernel, needs", [
    ("w8a8_gemm_sm90_kernel", ("IGMMA", "UTMALDG")),
    ("gemm_probe_i8_kernel", ("IGMMA", "UTMALDG")),
    ("gemm_probe_bf16_kernel", ("HGMMA", "UTMALDG")),
    ("gemm_probe_bf16_t_kernel", ("HGMMA", "UTMALDG")),
    ("sage_fwd_sm90_kernel", ("HGMMA", "UTMALDG", "IGMMA")),
    ("flash_fwd_sm90_kernel", ("HGMMA", "UTMALDG")),
])
def test_sass_gate_asks_each_kernel_for_its_wgmma(kernel, needs):
    """The SASS gate asks K3's and K9's int8 kernels for the int8 wgmma
    (IGMMA), the bf16 GEMM kernels and the attention kernels for HGMMA, K2's
    for both, every one for TMA loads; every wgmma kernel is pinned."""
    assert chip_smoke.sass_needs(kernel) == needs
    assert any(kernel in kernels for kernels in chip_smoke.WGMMA_KERNELS.values())
    assert kernel in chip_smoke.PINNED_REGISTERS
