"""airjax — ADS-B (1090 MHz Mode S) decode framework in JAX.

A JAX/XLA implementation of the capabilities of the
reference Rust SDR pipeline (jaxsonpd/air_rs): complex IQ sample streams
-> magnitude -> preamble/DF17 detection -> PPM bit-slicing -> CRC-24
check/recovery -> protocol field extraction -> CPR position decode ->
aircraft tracking -> stream/TUI/web display.

Unlike the reference's three-CPU-thread scalar scan, the hot path here is a
single jitted array program over fixed-size IQ blocks, sharded across
GPUs with overlap-save halo exchange so frames straddling block boundaries
are never dropped.

Layer map (reference file -> airjax module):
  src/utils.rs (c16 IO, magnitude)    -> airjax.io.c16, airjax.dsp.magnitude
  src/adsb/demod.rs                   -> airjax.dsp.demod
  src/adsb/crc.rs                     -> airjax.protocol.crc
  src/adsb/packet.rs, msgs.rs         -> airjax.protocol.{packet,fields}
  src/adsb/cpr.rs                     -> airjax.track.cpr
  src/adsb/aircraft.rs                -> airjax.track.aircraft
  src/adsb.rs (pipeline threads)      -> airjax.pipeline, airjax.io.source
  src/cli.rs, src/main.rs             -> airjax.cli
  src/sdr.rs, src/receive.rs          -> airjax.sdr, airjax.cli (receive)
  src/adsb/tui.rs, web.rs             -> airjax.ui.{tui,web,stream}
  (absent in reference)               -> airjax.parallel (mesh, halo),
                                         airjax.device (device, compile cache),
                                         airjax.extended (all downlink
                                         formats), airjax.protocol.commb
                                         (BDS registers), airjax.analytics
                                         (whole-capture tracks),
                                         airjax.track.cpr_batch
"""

from airjax.config import PipelineConfig

__version__ = "0.1.0"

__all__ = ["PipelineConfig", "__version__"]
