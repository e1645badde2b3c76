from . import flash_attention, ssd


def launch_counts() -> dict:
    """Each hand-written kernel's launches in this process, by name, from
    the count its wrapper keeps (one per call that launches the kernel)."""
    from .flash_attention import kernel as flash
    from .ssd import kernel as ssd_kernel

    return {"flash_attention_fwd": flash.flash_attention.launches,
            "flash_attention_bwd": flash.flash_attention_backward.launches,
            "ssd_fwd": ssd_kernel.ssd_scan.launches,
            "ssd_bwd": ssd_kernel.ssd_scan_backward.launches}


__all__ = ["flash_attention", "ssd", "launch_counts"]
