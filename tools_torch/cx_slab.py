"""The complex-omega slab sweeps beyond the Kelvin-Helmholtz case, as data.

`run_case_complex` at the CLI's defaults (12 x 10 Newton seeds per (k,
band) cell, 30 Newton steps, float64, the argument-principle audit on) on
three configurations that the JAX package's CLI reaches with `sweep
--complex` (`eigensolver_tpu/cli.py:91-98`, which makes any case complex):

- `cx_ph_09`: `cases.slab_density_photospheric(0.9)` with
  complex_omega=True, the flux form at complex omega: 35 k x 9 bands x 120
  = 37,800 seeds a mode, modes (0, 1), n_interior = 2048, the exact
  exterior;
- `cx_ph_09_num`: the same with exterior_method="numeric" (512 exterior
  steps from 1 + 3 2 pi / k, renormalised every 64);
- `kh_w1e5_num`: `cases.slab_flow_complex_coronal(1e5)` (the published KH
  sweep of tools_torch/kh.py, kink only, 7,200 seeds) with the numeric
  exterior: the shear form's numeric exterior at complex omega.

`TARGETS` holds what `run_case_complex` of the JAX package gives on a CPU
in float64 (JAX 0.9.0, x64), from

    python tests/test_torch_complex_slab.py jax-counts NAME

per branch: `counts`, the roots off the real axis by the audit's margin
(`counts_off_axis`), the per-seed verdicts (`kh.seed_verdicts`: accepted,
converged after one more Newton step) packed as `kh.pack_mask` packs them,
and `counts_converged`, the roots the converged accepted seeds give; the
audit's `completeness`. A density slab has no growing mode: its converging
seeds land on the real axis, so the audit's contours (lifted off the axis)
enclose no zero. Nothing here imports torch or jax.
"""
from __future__ import annotations

import dataclasses

RUN_KW = dict(n_re=12, n_im=10, newton_iters=30)

# name: (case factory, its keyword arguments, fields set on the case,
# exterior_method)
CONFIGS = {
    "cx_ph_09": ("slab_density_photospheric", dict(width=0.9),
                 dict(complex_omega=True), "bessel"),
    "cx_ph_09_num": ("slab_density_photospheric", dict(width=0.9),
                     dict(complex_omega=True), "numeric"),
    "kh_w1e5_num": ("slab_flow_complex_coronal", dict(width=1e5), {},
                    "numeric"),
}

TARGETS = {
    "cx_ph_09": {
        "counts": {"sausage": 76, "kink": 47},
        "counts_off_axis": {"sausage": 0, "kink": 0},
        "completeness": {"cells": 630, "checked": 630, "agree": 630, "missed": 0, "fraction": 1.0},
        "candidates": 75600,
        "k_stride": 1,
        "counts_converged": {"sausage": 76, "kink": 43},
        "accepted": {"sausage": 24512, "kink": 32940},
        "converged": {"sausage": 24512, "kink": 32576},
        "seeds_accepted": {
            "sausage": (
                "eNrtlUtPE1EUx6tddCFJie5L/AANoB8Ag4khYeHeRbcsXLCdtouChLhsXBGi"
                "tjHRxI1hYfGRSAYl2hjCI5KohNhBeRQSYSAiQ53euZ5z7zzuTAdaBkQWnKQn"
                "dx49/98959wzodCZOdYUdl+HQ+NtTbXuBDB8df3dKcGw3cljSLFI/6IPRsOF"
                "ajvoAYsyHopF3y56hWLhc/yeZD+VmiJ9QbLh02G+rcfVIv3fU4mhJ+upxN3B"
                "Ncm6Z/KZqzuz9bokXK/R93VdXLzWGZl8ucIvY9GJrWoHOElIU6QvVMPiCe/O"
                "n7fSwnsQL/FSJqZ4vrwnxVpW1iSUrMo9w6vJXM/wMhAUK0gFT6Pjrn4RGWrV"
                "7Eo7ku48mw4eFKhtcu/CLkGXZARy7zxi3Of3SAdPSbFyxcnkxYPHjZ9krYOg"
                "72YLtri/ywh8GqWabJDYpcu8Y4WW95ZiX13cjHhvAPZ24cb8C38CxSUOloaf"
                "AZffVGB59SGJUXzr4Zwt76b5zkUMWA1sG5mhxx9fwH4NYhYFxKkKLiPrSDC3"
                "zfqUtQXWQ4fHRE1TbWyzPddzD0Kxs+9pPVY867BX7fY2XcsSriYh/E12uYIH"
                "4mnxKhVMq3BdqqB4lr3HMJYcoIpR0sbUNGD8SOauuycDS4S1X1HcJIAo2ckd"
                "+x4PmiqVH0y3CxSKJSQ6+K/JYrnE0AhNY+8mc9fON4fERACGVxzVOEG+rFNw"
                "f4iAIUO5S9qb6XZcCYmwXjZXrgeYoRkoWX5l3cDOGXzkZAN6TWhCB0MMRYl7"
                "g1tVJl368mwj5SoKvKyoxGDisPLJEG5rRIF4Iwu7U8+7O5sL5jwwMUzx7IRY"
                "xtqtosPwKhwDqr1elmgd06zNcCqAzGSnYDkz6cKw28KTA5PAtVUhQ4iRkckm"
                "qYdBMTnuhHHTGcZsIY6l6Ii+5+PfbiS9TlAnGzJ2O23EmLjmjowYt299Ho3D"
                "N0+yxPeqQsYbMX2niuN6igazEsXR0t35aRQHgCR0TsME3GBoaWM/uwJiwFiv"
                "whjuxK/BHPZk0Zo5hzLWcOWHG9NBMWCeQpTVr4V4K05bjqEeNojC/0GCYbBM"
                "2hgLv00MmQbBgI8IMQLmAj+96RJOlXgrjpH80q8gYaxsGPRIxqaKSuqf0MMM"
                "haAYOOBV+n8wdE2YQwHa4l9gHNGOWpRjwjiGfZwqDEU9ywba8WD8BbQD824="),
            "kink": (
                "eNpjYBgUgIeZ4YABjQkinCHH3vigQg6ig/EBrdyC1WRMZ9CJwB1W9vyHP/yh"
                "mJCDsA5CbCNKG3sDzC0gZ9TPf/7zH26inwxXffxHwFAI8fRllc9klROQ6CFK"
                "B62IuOlLX4CDhOH/wIK/b6vAieb/QIPqeekzn1QMvDPuPR8Mzvj///vOUWcg"
                "gZ+Dwxm/vwwSZ/wZdcaoM0adQRj8GXUGUmn+Y3A44+e/UWeMOmMwO+P/31Fn"
                "jDpj1BlEOQMAwuER/Q=="),
        },
        "seeds_converged": {
            "sausage": (
                "eNrtlUtPE1EUx6tddCFJie5L/AANoB8Ag4khYeHeRbcsXLCdtouChLhsXBGi"
                "tjHRxI1hYfGRSAYl2hjCI5KohNhBeRQSYSAiQ53euZ5z7zzuTAdaBkQWnKQn"
                "dx49/98959wzodCZOdYUdl+HQ+NtTbXuBDB8df3dKcGw3cljSLFI/6IPRsOF"
                "ajvoAYsyHopF3y56hWLhc/yeZD+VmiJ9QbLh02G+rcfVIv3fU4mhJ+upxN3B"
                "Ncm6Z/KZqzuz9bokXK/R93VdXLzWGZl8ucIvY9GJrWoHOElIU6QvVMPiCe/O"
                "n7fSwnsQL/FSJqZ4vrwnxVpW1iSUrMo9w6vJXM/wMhAUK0gFT6Pjrn4RGWrV"
                "7Eo7ku48mw4eFKhtcu/CLkGXZARy7zxi3Of3SAdPSbFyxcnkxYPHjZ9krYOg"
                "72YLtri/ywh8GqWabJDYpcu8Y4WW95ZiX13cjHhvAPZ24cb8C38CxSUOloaf"
                "AZffVGB59SGJUXzr4Zwt76b5zkUMWA1sG5mhxx9fwH4NYhYFxKkKLiPrSDC3"
                "zfqUtQXWQ4fHRE1TbWyzPddzD0Kxs+9pPVY867BX7fY2XcsSriYh/E12uYIH"
                "4mnxKhVMq3BdqqB4lr3HMJYcoIpR0sbUNGD8SOauuycDS4S1X1HcJIAo2ckd"
                "+x4PmiqVH0y3CxSKJSQ6+K/JYrnE0AhNY+8mc9fON4fERACGVxzVOEG+rFNw"
                "f4iAIUO5S9qb6XZcCYmwXjZXrgeYoRkoWX5l3cDOGXzkZAN6TWhCB0MMRYl7"
                "g1tVJl368mwj5SoKvKyoxGDisPLJEG5rRIF4Iwu7U8+7O5sL5jwwMUzx7IRY"
                "xtqtosPwKhwDqr1elmgd06zNcCqAzGSnYDkz6cKw28KTA5PAtVUhQ4iRkckm"
                "qYdBMTnuhHHTGcZsIY6l6Ii+5+PfbiS9TlAnGzJ2O23EmLjmjowYt299Ho3D"
                "N0+yxPeqQsYbMX2niuN6igazEsXR0t35aRQHgCR0TsME3GBoaWM/uwJiwFiv"
                "whjuxK/BHPZk0Zo5hzLWcOWHG9NBMWCeQpTVr4V4K05bjqEeNojC/0GCYbBM"
                "2hgLv00MmQbBgI8IMQLmAj+96RJOlXgrjpH80q8gYaxsGPRIxqaKSuqf0MMM"
                "haAYOOBV+n8wdE2YQwHa4l9gHNGOWpRjwjiGfZwqDEU9ywba8WD8BbQD824="),
            "kink": (
                "eNpjYBgKgJmBwYCHYcQAOfbGBxX0Igx4mBkOoBNgZ9jzH/7wh2JCDsI6CLGN"
                "KG3sDTC3gJxRP//5z3+4iX4yXPXxHwFDIcTTl1U+k1VOgNxC0Bm0JeKmL30B"
                "DhKG/wML/r6tAiea/wMNquelz3xSMfDOuPd8MDjj///vO0edgQR+Dg5n/P4y"
                "SJzxZ9QZo84YdQZh8GfUGUil+Y/B4Yyf/0adMeqMweyM/39HnTHqjFFnEOUM"
                "AFxK5Pc="),
        },
    },
    "cx_ph_09_num": {
        "counts": {"sausage": 78, "kink": 48},
        "counts_off_axis": {"sausage": 0, "kink": 0},
        "completeness": {"cells": 630, "checked": 630, "agree": 630, "missed": 0, "fraction": 1.0},
        "candidates": 75600,
        "k_stride": 1,
        "counts_converged": {"sausage": 78, "kink": 44},
        "accepted": {"sausage": 24574, "kink": 32960},
        "converged": {"sausage": 29742, "kink": 33308},
        "seeds_accepted": {
            "sausage": (
                "eNrtVs9LFHEUH9vDHhJW6r7RORa1/oABgwo8BB0L9hR46OB1dvewWkhH6SRi"
                "uHQIggIPrVaUjGWxhKhbQiXi7vpzE8LRUsdtfnx73x8z892Z0f1huR564GN+"
                "fPe9z/u8z3ujIPw3x5oDgtDG3QeEibZmrzsGGL55/d0JgWG744chhYO9BR8Y"
                "R28Ui4J7LobeFtyJwoEm+kwKW2+l5mBPrWwEqidboNmCvUvx6MDjjXj0ft93"
                "yXrG8LGru9lKKglUEnqbqxiHcZrc68xkqliit+HQ5JYugpM4moI9ggfLwSmb"
                "ChbPdqe5cxAv+kI2WHKSN7VUkHBKXe6eX48Ndw2uAoJMCaPahx5NlOmFx+BT"
                "OT6CsTgpy3lmDl6kkW1y98KegV1M7hpcjzEYQ/SZAdC2zWR/pnTRTnTtzOHr"
                "xpNyOeYDA6p8l03byf1dkuJTEVKwU1/v6OGz56liOcm7W+HKBkLXRXo1BQG4"
                "t/eg3aevzI/5I8g75KiEqgT8mXC7qACWl+9JFN9+OLPlLppWDu12ngEMoHjo"
                "9scxqNc0WFMgOVLAJWUNI5jbJjolsoAAs/iQoSSQOr7ZPnwVhyKz71oyRM9O"
                "otDkT0O0NK6L51bw1RSEv05u1/BAPMlcQpypJZoX5XHyfnKOwFhxAJXMnDqu"
                "JIa7PxFxlW0GQoRVr84lZwiwuKAp1jMaNJ4rPpxp51CQ5LKFhTn4rTUpzEUH"
                "RlACtLsDbJxqEeyRpLvOUzlkowhSRQ2B+21wMGRod059MxNzEWEdZldlL8CN"
                "4Jal1jZMrJy+R5dtNkBrlhwdDjJ8UNzR8gK3dJr767PpuKcpimGSK5RXLIbK"
                "yQEsEO/prb3p550dLWm2DxgMisDVRly0p6IUDq/AGCD11aqEKpjqFGOh6p+G"
                "CLNTHAz27WEc7OscsbJvPCsohiGKxqZRCQbC5PiZRmBk0xHcCjH0ga5/k4na"
                "rvegoA4bcteD5RiqxlTNcuUw7tz8MhoJORMFg001LqMqTduBr8biDwnVZzmy"
                "zTo7Po/KeINwyjmEgwNMga8Gqtt0XbxwIwvFzG3pHjlWaWQMioNrZt0oDIiQ"
                "X/+WFlvn6DfPmrKaYaiyrtcFAdY/rFIKIyJquwyGXHOgvHLoGFQ0/OlN5PKg"
                "yUjrwi6Wxa96whwVhmvhcaulEaay9VDHfFSzm2oIQGHIqEEwNJVfhwidBDYa"
                "bUY92+JfwGD/ECiNZwOdAPs7MP4A+DX59Q=="),
            "kink": (
                "eNpjYBgUgIeZ4YABFQmQmdjECAA59sYHFXIQHYwPDKjtKh48JmM6g04EzvBj"
                "sOc//OEPQeLjv/p+fErk5B+DWAchtv0hxlD2BphbQM6on//85z98xA9iDN3v"
                "j+pmVFP+38dm8tOXVT6TVU5AooegM7ARv/9jN5lUIm771hfgIGH4P7Dg79sq"
                "cKL5P9Cgel76zCcVA++Me88HgzP+//++c3A4Y++bweCM/z8HRWj8//1lkDjj"
                "z6gzRp0xmJ3x/8+oMwadM77/GBzOADbQRp0x6gzsLdJRZ4w6Y9QZQ8kZAClK"
                "FPQ="),
        },
        "seeds_converged": {
            "sausage": (
                "eNrtVV1MU2cYPoUOMTYp67LI4lIhq7rFEEq7RJPNtdGLMdbExYu5zKW44c8y"
                "1zSZF7Y9ZgeDyAUuJcGFMbYysx8uFsIF0GZh5EBY+JlAQZ3YdZ6WoVSG9YgF"
                "DrU959v7ndPWgpsokmiWvRdvzvf7Pu/zPu93COJJsS4tdgSRiQfZRmmumJCX"
                "P8jZpROKf9ikTlx6n7MKCK5NO5sJqEy1eV1aBf5KOSI/e2fOSdEljsnyilWa"
                "ek2xSn4iaFOlYxbTSrueMNbkSSOtOMTWVrBuZw6hkldoYUt2VpFiTXmXVp25"
                "drLodFnuLzZ1piwIm8Gp18D1akBgK9iwv6tNkSkfcFtqNGtPYZdhLJdjl5GT"
                "jJcBIFNxYTgSN0AgbeuH72QV4bGs3CgLEoT8RF4xRmpTY7jGWs1ah6lc3k8o"
                "1n/TrROjmWs1AzpTwwFw8CVQDYd8bkvjpM8NwEcAhmxcZ6qAfRCoWydVMJmb"
                "VpWXg1nLlhPqzOxeGWTUKysvy5VrCci3LV/Zoz2Zj2nH1LUpiKde0pnqvp8q"
                "eb/uuwGHpTFIaJuPvDdcFI5siwomiAvBDwy4TbVbYvpBzu0DQJt9grmq8rpN"
                "vc7Y7bZUZIy0GTZgpDWbpsBt9un2YHLwsGRPrab/ZP6GQ8+5j55pLsgw1mh+"
                "LSI0NUSbKvuNawLl7O/l6SP75vnmj/1zw0edPbfiRE5eF0FVG8E5h27EUah+"
                "0s6EvrzU3kwJAYSm93HIdbh+kqetvqs22uqf52kq7iWZiY0IoYnnvfrT+3N7"
                "i8Blybpmf5qsNFVkXYZy79IO6gn5Ob2xQg501m66TgCTo+6CZzbjjAA4VdcU"
                "FQzrdt2CzcW9PPUjoKKPvHtJpt7WMScYlH0xkuE6wwLe51Bva79uM1dhbaw5"
                "8afd7OyJkK69P8BVVdXzdtcxWFUTWblxQ/bOEUKh+aK3aHCwb/ugfutbslPq"
                "9WfHdaoXng7GDYVXWNLS+qpXH45RAkQrFey0daQHUfTtUbelroXXIf/BKXc4"
                "Rs4JiKMRYhDPIsrTyUKufFgwe2heoGCeZALhsIMJTMwAp+fmHOaGsghJH26E"
                "Be7nYZ5+c/eOkvORV162GQovABGFI102S1U1p2eQaDxLMhED8pgbDk4JVCOL"
                "PIatb/sRExifQIj9fQxRHceH22krwMUhIVCYFc/h4LyAUGQGXDSEENd5k6ca"
                "Q1F8C+8wN076Sbo02O1g+iqnPeH4LWiNLV+HHfkv7uNATZ0sKQWPffpHW4Gy"
                "O6h1UfEhB/J/MCpQLQGBR2NNCzagHaKxfo5ErO+aYG4ZiwooZSABLrEKRqLF"
                "Rjn7oiJIHQqd6bdRDR9d4rFo7OhiC0J7gElS5DQsneXFQLMQsoNLJAhskFRV"
                "5ZTAiMOmesiSxdBQDEvvbqiYBCMxYv2JVdoaSO7AFUSBiQgQG1oY1GfKJshx"
                "L+A7Tc0B7Q1W3oFQ3Isg3xs29ZbP/+LVyiEWMewVTHYUJL/73DxvKIRUmbEW"
                "wFLl5FNEAKBEcAHHFZLQloBMgztvpzwds8UqZd/2OFo4PiSYaS6K5TMbd1lx"
                "DMRFHWY6ek1ISzDUMAeUYJnVNcWkOSnBAMsvKkoyaYoGBECYpFOE6UR0KZtQ"
                "HaaEpPeeBZldLoNLv312moSaA4yOT87zlNPLCzQVvQqdMhYD8XN3MO2zeAgS"
                "CIDMDEovThX0Z9iIC1XXslgCOCOai2F8MPL24a+QKB9c2lBUQsWIWKCjIN95"
                "n8Pc+lrA02z9bcphdnYHbXTp9Dyv3sgmMwJlC+IcXRqKJQNFcOd5pVUHCn3l"
                "TUcRYFNfqRN4jsKMi4DEPhKxuI5Bg5lbdSPFpgrFkDvMBuJxg7JnxpF2ViI2"
                "0btpxFItY3ekcidXsU6T+xaVn0/wkspIvAAKhaGFw4L0xbVPuSl4SxBNYSab"
                "GgFfqbQPaLeOJYgFJmPonkCRSLru728SQ9wiOsWnRYSBbo8K8Pe7bHOBsu2u"
                "1z+7meQexxB5WUzO0rRE7eK3aTkc3L1XSQhiYm/tECzVJRfjjChCJVaT13sP"
                "nf9umDVqeTKWsRjFuyUpo7lpSeNLdLUcz6IsxLMPaktzk94Xj6XlQiT5ToYW"
                "4g+bCH6bePbR2GCZgAeFameE1HONEjV/KONv2leOAVf/zkVIn7vLwZJ+e8AO"
                "gJ/6I7EhvSogVgr/JVeuNYFf6Ump2bkl79CKiUWP1QLsqlyT/AE9eu+viv0P"
                "IymuVarvfwGGWI/H3W/oCUCwyr3/RDTJ32Ieejw="),
            "kink": (
                "eNrtVjtLw1AUTlqxFQotLupSK4hz+wsqurQ4OLqVgqBj19IOsWi3go+lCqJ0"
                "cHBwdHCK4uAgqODgINT4TB0kFalpyeN4btJoH9G1Ee43fDn33JzvfPckhDCM"
                "oxEb7FvCi5thwj4rh5HrauXvOp+b1Halj21u7c55pwIrY2bIhmKEfunGhhiz"
                "R2i4P76RDLRtGsbJEcxLYHzA1YwmRlyTmwtIa+NeW93yTUlQg/7Tdz3oyd3r"
                "3K5YV6OenJCOepar6aAnX1Gj/hMBo1yTOpYm+c/q5ObXjLFMFPcq1m7eioZK"
                "QrgwE38K+9yuKyTmGIl9iCwlh/vZKHGAVFWNiONB1/jU7acGEhLPKTIAIHG8"
                "3CAmO6jeLNt9RIFRsZ4ui+uPwHNEhQMCxZJKXX8An7oDMDfE7YvDwnzgJBMk"
                "jxua0Gx6/DSqqoY1lDK6WburZw0dLk9RfvYc7ZrGoRt3omKFsgKWMsnVKuHC"
                "NCswrS0lUiFpOpY1yFzsrBkqP6JG2W9HQD3bIX7nEjj7yM7cgTQDvYX2pieK"
                "+y8R6DWy/OLWU7rnNqAsHz1nwAFQ5KwTbGhSlk6jZRzOeDdquiNs4Pee2viG"
                "qlIbjrOh6XQa0PLXQm04DXQaFBT/6WNO0f5QvgBQTDju"),
        },
    },
    "kh_w1e5_num": {
        "counts": {"kink": 49},
        "counts_off_axis": {"kink": 10},
        "completeness": {"cells": 60, "checked": 60, "agree": 60, "missed": 0, "fraction": 1.0},
        "candidates": 7200,
        "k_stride": 1,
        "counts_converged": {"kink": 49},
        "accepted": {"kink": 4614},
        "converged": {"kink": 6144},
        "seeds_accepted": {
            "kink": (
                "eNpjYCAFCKhJthXPeW75r37+4w9/7PmP/wSyHj6skmNv/lABIfgPgyQOf6h4"
                "+KNO/vznP//tz/8nDA58sJNvfwhS/JmwYgYGDnbmA1DjCSsGgoYEGf52YhWD"
                "jQe5hTjFDEyMB37UE6sYBFi4GBvc+//+Q5K+//hDBQMzw4GK+v2oigUUGDyE"
                "MAz/Y8DA3nDAgEFBACV6FOTksdm9HUw+/GCAGpl88rid+/mDBQuKYh5+PJ77"
                "UUGSYjZGZMUc7PgUF6ClQGY8itE9OECKHwiQqBgAyv484A=="),
        },
        "seeds_converged": {
            "kink": (
                "eNpjYCAFCKhJthXPeW75r37+4w9/7PmP/wSyHj6skmNv/lABIfgPgyQOf6h4"
                "+KNO/vznP//tz/8nDA58sLff/hCk+DNhxQwKEuzeB37U3QcZT1AxCDSkz+Fv"
                "J0JxQ4IIB0NDygz2/w8JK14YkahUeemxCLfxgf//7bGr+b4fyljrf/SFR9Bi"
                "IcFtPAwsXIwN7v1//yGpu//4QwUDM8OBinqwhvfXf1fX7//9rXV//IMDHkIY"
                "hv+pYGBvOFAhZ/9/uIPvv0lQu31QKH4+nUTFANaZ/0c="),
        },
    },
}


def configure(name: str, cases, **case_kw):
    """(case, run_case_complex's keyword arguments) of `name` with one
    package's `cases` module; `case_kw` replaces case fields (a test's
    reduced k grid); `n_interior` there sets the grid's."""
    fac, fac_kw, fields, exterior = CONFIGS[name]
    case = getattr(cases, fac)(**fac_kw)
    n_interior = case_kw.pop("n_interior", case.grid.n_interior)
    case = dataclasses.replace(
        case, **fields, **case_kw,
        grid=dataclasses.replace(case.grid, exterior_method=exterior,
                                 n_interior=n_interior))
    return case, dict(RUN_KW)
