"""The port's mDNS advertiser and browser (net/mdns.py, the avahi.c analog)
over loopback multicast: the twin of tests/test_mdns.py, and each package's
browser finding the other's advertisement with the same record."""
import os
import time

import pytest

from ka9q_radio_tpu.net import mdns as jmdns
from ka9q_radio_tpu_torch.net import mdns as tmdns


@pytest.mark.parametrize("adv_pkg,browse_pkg", [(tmdns, tmdns), (tmdns, jmdns), (jmdns, tmdns)],
                         ids=["port-port", "port-jax", "jax-port"])
def test_mdns_advertise_and_browse(adv_pkg, browse_pkg):
    tag = f"{os.getpid()}{'p' if adv_pkg is tmdns else 'j'}{'p' if browse_pkg is tmdns else 'j'}"
    assert tmdns.SVC_CTL == jmdns.SVC_CTL
    adv = adv_pkg.MdnsAdvertiser(hostname=f"torchtest{tag}")
    adv.add_service(adv_pkg.SVC_CTL, f"radio-{tag}", 5006,
                    {"status": "test.local", "source": "sig_gen"})
    adv.start()
    try:
        time.sleep(0.3)
        results = browse_pkg.browse(browse_pkg.SVC_CTL, timeout=2.0)
        mine = [r for r in results if r.get("instance") == f"radio-{tag}"]
        assert mine, results
        e = mine[0]
        assert e["port"] == 5006
        assert e["txt"] == {"status": "test.local", "source": "sig_gen"}
        assert e.get("addr")
    finally:
        adv.stop()
