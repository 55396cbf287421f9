"""TPC-DS synthetic data connector.

Reference analog: ``plugin/trino-tpcds`` (TpcdsConnectorFactory,
TpcdsMetadata wrapping the teradata dsdgen port).

Like the TPC-H connector this is a from-scratch, vectorized,
counter-based generator (every value a pure function of
(table, column, row) through splitmix64) — NOT a dsdgen port. Schemas
follow the TPC-DS v2 specification for the star-schema subset the
benchmark queries exercise (15 tables: the store/catalog sales channels
with their returns, inventory, and the shared dimensions). Value
distributions are plausible rather than dsdgen-exact; correctness
testing cross-checks queries against a sqlite oracle loaded with THIS
generator's data (same contract as the TPC-H oracle suite), and the
micro scale biases item color/price so the filter-heavy benchmark
queries (q64/q72) keep non-trivial selectivity.

Facts link the way the spec requires: store_returns rows derive from
their originating store_sales rows (join on item_sk + ticket_number),
catalog_returns from catalog_sales (item_sk + order_number), and
inventory covers every (week, item, warehouse) cell of the date range.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import types as T
from ..block import Block, Dictionary, Page
from ..expr.functions import days_from_civil_host
from .spi import (ColumnHandle, Connector, ConnectorMetadata,
                  ConnectorPageSource, ConnectorSplit, ConnectorSplitManager,
                  ColumnStatistics, TableHandle, TableStatistics)
from .tpch import COLORS, _TEXT_WORDS, _comment, h64, hmod

V = T.varchar_type
D72 = T.decimal_type(7, 2)
D52 = T.decimal_type(5, 2)

# -- spec value domains (TPC-DS v2 §3; shared constants, not dbgen output) --

BUY_POTENTIAL = [">10000", "5001-10000", "1001-5000", "501-1000", "0-500",
                 "Unknown"]
MARITAL = ["M", "S", "D", "W", "U"]
GENDER = ["M", "F"]
EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree",
             "4 yr Degree", "Advanced Degree", "Unknown"]
CREDIT_RATING = ["Low Risk", "Good", "High Risk", "Unknown"]
STREET_TYPES = ["Street", "Ave", "Blvd", "Way", "Ct", "Ln", "Dr", "Pkwy",
                "Road", "Circle"]
LOCATION_TYPES = ["apartment", "condo", "single family"]
STATES = ["AL", "CA", "GA", "IA", "IL", "KS", "MI", "MN", "MO", "NC",
          "NE", "NY", "OH", "OK", "OR", "TN", "TX", "VA", "WA", "WI"]
SALUTATIONS = ["Mr.", "Mrs.", "Ms.", "Dr.", "Miss", "Sir"]
CATEGORIES = ["Books", "Children", "Electronics", "Home", "Jewelry",
              "Men", "Music", "Shoes", "Sports", "Women"]
CLASSES = ["accent", "accessories", "athletic", "classical", "custom",
           "dresses", "estate", "fiction", "fragrances", "pants"]
UNITS = ["Each", "Dozen", "Case", "Pallet", "Gross", "Box", "Carton",
         "Unknown"]
SIZES = ["small", "medium", "large", "extra large", "petite", "N/A"]
CONTAINERS = ["Unknown"]
DAY_NAMES = ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
             "Saturday", "Sunday"]
HOURS = ["8AM-4PM", "8AM-8PM", "8AM-12AM"]
#: the q64 filter colors — micro-scale bias keeps the query selective
#: but non-empty (see module docstring)
Q64_COLORS = ["purple", "burlywood", "indian", "spring", "floral", "medium"]

_DS_START = days_from_civil_host(1998, 1, 1)      # date_dim coverage
_DS_DAYS = days_from_civil_host(2002, 12, 31) - _DS_START + 1   # 1826
_SOLD_DAYS = days_from_civil_host(2001, 12, 31) - _DS_START + 1  # sales span
_SK0 = 2450815          # d_date_sk of the first covered day
_WEEK_SEQ0 = 5270       # arbitrary but stable week-sequence base

_SCHEMAS = {"micro": 0.001, "tiny": 0.01, "sf1": 1.0, "sf10": 10.0,
            "sf100": 100.0, "sf1000": 1000.0}


def _counts(sf: float) -> Dict[str, int]:
    c = {
        "date_dim": _DS_DAYS,
        "income_band": 20,
        "item": max(1000, int(18_000 * sf)),
        "customer": max(200, int(100_000 * sf)),
        "customer_address": max(100, int(50_000 * sf)),
        "customer_demographics": max(400, min(1_920_800,
                                              int(1_920_800 * sf))),
        "household_demographics": max(72, min(7_200, int(7_200 * sf))),
        "promotion": max(10, int(300 * sf)),
        "store": max(2, int(12 * sf)),
        "warehouse": max(2, int(5 * sf)),
        "store_sales": max(100, int(2_880_000 * sf)),
        "catalog_sales": max(100, int(1_440_000 * sf)),
    }
    c["store_returns"] = c["store_sales"] // 2
    c["catalog_returns"] = c["catalog_sales"] // 3
    c["inventory"] = ((_DS_DAYS + 6) // 7) * c["warehouse"] \
        * min(c["item"], max(200, int(c["item"] * 0.2)))
    # web channel + remaining dimensions (full 24-table schema)
    c["time_dim"] = 86_400
    c["reason"] = 35
    c["ship_mode"] = 20
    c["call_center"] = max(2, int(6 * sf))
    c["catalog_page"] = max(100, int(11_718 * sf))
    c["web_site"] = max(2, int(30 * sf))
    c["web_page"] = max(10, int(60 * sf))
    c["web_sales"] = max(100, int(720_000 * sf))
    c["web_returns"] = c["web_sales"] // 3
    return c


def _inv_items(sf: float) -> int:
    """Items covered by inventory (a dense prefix of item_sk)."""
    c = _counts(sf)
    return min(c["item"], max(200, int(c["item"] * 0.2)))


_TABLE_COLUMNS: Dict[str, List] = {
    "date_dim": [
        ("d_date_sk", T.BIGINT), ("d_date_id", V(16)), ("d_date", T.DATE),
        ("d_month_seq", T.BIGINT), ("d_week_seq", T.BIGINT),
        ("d_quarter_seq", T.BIGINT), ("d_year", T.BIGINT),
        ("d_dow", T.BIGINT), ("d_moy", T.BIGINT), ("d_dom", T.BIGINT),
        ("d_qoy", T.BIGINT), ("d_fy_year", T.BIGINT),
        ("d_fy_quarter_seq", T.BIGINT), ("d_fy_week_seq", T.BIGINT),
        ("d_day_name", V(9)), ("d_quarter_name", V(6)), ("d_holiday", V(1)),
        ("d_weekend", V(1)), ("d_following_holiday", V(1)),
        ("d_first_dom", T.BIGINT), ("d_last_dom", T.BIGINT),
        ("d_same_day_ly", T.BIGINT), ("d_same_day_lq", T.BIGINT),
        ("d_current_day", V(1)), ("d_current_week", V(1)),
        ("d_current_month", V(1)), ("d_current_quarter", V(1)),
        ("d_current_year", V(1))],
    "item": [
        ("i_item_sk", T.BIGINT), ("i_item_id", V(16)),
        ("i_rec_start_date", T.DATE), ("i_rec_end_date", T.DATE),
        ("i_item_desc", V(200)), ("i_current_price", D72),
        ("i_wholesale_cost", D72), ("i_brand_id", T.BIGINT),
        ("i_brand", V(50)), ("i_class_id", T.BIGINT), ("i_class", V(50)),
        ("i_category_id", T.BIGINT), ("i_category", V(50)),
        ("i_manufact_id", T.BIGINT), ("i_manufact", V(50)),
        ("i_size", V(20)), ("i_formulation", V(20)), ("i_color", V(20)),
        ("i_units", V(10)), ("i_container", V(10)),
        ("i_manager_id", T.BIGINT), ("i_product_name", V(50))],
    "customer": [
        ("c_customer_sk", T.BIGINT), ("c_customer_id", V(16)),
        ("c_current_cdemo_sk", T.BIGINT), ("c_current_hdemo_sk", T.BIGINT),
        ("c_current_addr_sk", T.BIGINT),
        ("c_first_shipto_date_sk", T.BIGINT),
        ("c_first_sales_date_sk", T.BIGINT), ("c_salutation", V(10)),
        ("c_first_name", V(20)), ("c_last_name", V(30)),
        ("c_preferred_cust_flag", V(1)), ("c_birth_day", T.BIGINT),
        ("c_birth_month", T.BIGINT), ("c_birth_year", T.BIGINT),
        ("c_birth_country", V(20)), ("c_login", V(13)),
        ("c_email_address", V(50)), ("c_last_review_date_sk", T.BIGINT)],
    "customer_address": [
        ("ca_address_sk", T.BIGINT), ("ca_address_id", V(16)),
        ("ca_street_number", V(10)), ("ca_street_name", V(60)),
        ("ca_street_type", V(15)), ("ca_suite_number", V(10)),
        ("ca_city", V(60)), ("ca_county", V(30)), ("ca_state", V(2)),
        ("ca_zip", V(10)), ("ca_country", V(20)), ("ca_gmt_offset", D52),
        ("ca_location_type", V(20))],
    "customer_demographics": [
        ("cd_demo_sk", T.BIGINT), ("cd_gender", V(1)),
        ("cd_marital_status", V(1)), ("cd_education_status", V(20)),
        ("cd_purchase_estimate", T.BIGINT), ("cd_credit_rating", V(10)),
        ("cd_dep_count", T.BIGINT), ("cd_dep_employed_count", T.BIGINT),
        ("cd_dep_college_count", T.BIGINT)],
    "household_demographics": [
        ("hd_demo_sk", T.BIGINT), ("hd_income_band_sk", T.BIGINT),
        ("hd_buy_potential", V(15)), ("hd_dep_count", T.BIGINT),
        ("hd_vehicle_count", T.BIGINT)],
    "income_band": [
        ("ib_income_band_sk", T.BIGINT), ("ib_lower_bound", T.BIGINT),
        ("ib_upper_bound", T.BIGINT)],
    "promotion": [
        ("p_promo_sk", T.BIGINT), ("p_promo_id", V(16)),
        ("p_start_date_sk", T.BIGINT), ("p_end_date_sk", T.BIGINT),
        ("p_item_sk", T.BIGINT), ("p_cost", T.decimal_type(15, 2)),
        ("p_response_target", T.BIGINT), ("p_promo_name", V(50)),
        ("p_channel_dmail", V(1)), ("p_channel_email", V(1)),
        ("p_channel_catalog", V(1)), ("p_channel_tv", V(1)),
        ("p_channel_radio", V(1)), ("p_channel_press", V(1)),
        ("p_channel_event", V(1)), ("p_channel_demo", V(1)),
        ("p_channel_details", V(100)), ("p_purpose", V(15)),
        ("p_discount_active", V(1))],
    "store": [
        ("s_store_sk", T.BIGINT), ("s_store_id", V(16)),
        ("s_rec_start_date", T.DATE), ("s_rec_end_date", T.DATE),
        ("s_closed_date_sk", T.BIGINT), ("s_store_name", V(50)),
        ("s_number_employees", T.BIGINT), ("s_floor_space", T.BIGINT),
        ("s_hours", V(20)), ("s_manager", V(40)), ("s_market_id", T.BIGINT),
        ("s_geography_class", V(100)), ("s_market_desc", V(100)),
        ("s_market_manager", V(40)), ("s_division_id", T.BIGINT),
        ("s_division_name", V(50)), ("s_company_id", T.BIGINT),
        ("s_company_name", V(50)), ("s_street_number", V(10)),
        ("s_street_name", V(60)), ("s_street_type", V(15)),
        ("s_suite_number", V(10)), ("s_city", V(60)), ("s_county", V(30)),
        ("s_state", V(2)), ("s_zip", V(10)), ("s_country", V(20)),
        ("s_gmt_offset", D52), ("s_tax_precentage", D52)],
    "warehouse": [
        ("w_warehouse_sk", T.BIGINT), ("w_warehouse_id", V(16)),
        ("w_warehouse_name", V(20)), ("w_warehouse_sq_ft", T.BIGINT),
        ("w_street_number", V(10)), ("w_street_name", V(60)),
        ("w_street_type", V(15)), ("w_suite_number", V(10)),
        ("w_city", V(60)), ("w_county", V(30)), ("w_state", V(2)),
        ("w_zip", V(10)), ("w_country", V(20)), ("w_gmt_offset", D52)],
    "inventory": [
        ("inv_date_sk", T.BIGINT), ("inv_item_sk", T.BIGINT),
        ("inv_warehouse_sk", T.BIGINT),
        ("inv_quantity_on_hand", T.BIGINT)],
    "store_sales": [
        ("ss_sold_date_sk", T.BIGINT), ("ss_sold_time_sk", T.BIGINT),
        ("ss_item_sk", T.BIGINT), ("ss_customer_sk", T.BIGINT),
        ("ss_cdemo_sk", T.BIGINT), ("ss_hdemo_sk", T.BIGINT),
        ("ss_addr_sk", T.BIGINT), ("ss_store_sk", T.BIGINT),
        ("ss_promo_sk", T.BIGINT), ("ss_ticket_number", T.BIGINT),
        ("ss_quantity", T.BIGINT), ("ss_wholesale_cost", D72),
        ("ss_list_price", D72), ("ss_sales_price", D72),
        ("ss_ext_discount_amt", D72), ("ss_ext_sales_price", D72),
        ("ss_ext_wholesale_cost", D72), ("ss_ext_list_price", D72),
        ("ss_ext_tax", D72), ("ss_coupon_amt", D72), ("ss_net_paid", D72),
        ("ss_net_paid_inc_tax", D72), ("ss_net_profit", D72)],
    "store_returns": [
        ("sr_returned_date_sk", T.BIGINT), ("sr_return_time_sk", T.BIGINT),
        ("sr_item_sk", T.BIGINT), ("sr_customer_sk", T.BIGINT),
        ("sr_cdemo_sk", T.BIGINT), ("sr_hdemo_sk", T.BIGINT),
        ("sr_addr_sk", T.BIGINT), ("sr_store_sk", T.BIGINT),
        ("sr_reason_sk", T.BIGINT), ("sr_ticket_number", T.BIGINT),
        ("sr_return_quantity", T.BIGINT), ("sr_return_amt", D72),
        ("sr_return_tax", D72), ("sr_return_amt_inc_tax", D72),
        ("sr_fee", D72), ("sr_return_ship_cost", D72),
        ("sr_refunded_cash", D72), ("sr_reversed_charge", D72),
        ("sr_store_credit", D72), ("sr_net_loss", D72)],
    "catalog_sales": [
        ("cs_sold_date_sk", T.BIGINT), ("cs_sold_time_sk", T.BIGINT),
        ("cs_ship_date_sk", T.BIGINT), ("cs_bill_customer_sk", T.BIGINT),
        ("cs_bill_cdemo_sk", T.BIGINT), ("cs_bill_hdemo_sk", T.BIGINT),
        ("cs_bill_addr_sk", T.BIGINT), ("cs_ship_customer_sk", T.BIGINT),
        ("cs_ship_cdemo_sk", T.BIGINT), ("cs_ship_hdemo_sk", T.BIGINT),
        ("cs_ship_addr_sk", T.BIGINT), ("cs_call_center_sk", T.BIGINT),
        ("cs_catalog_page_sk", T.BIGINT), ("cs_ship_mode_sk", T.BIGINT),
        ("cs_warehouse_sk", T.BIGINT), ("cs_item_sk", T.BIGINT),
        ("cs_promo_sk", T.BIGINT), ("cs_order_number", T.BIGINT),
        ("cs_quantity", T.BIGINT), ("cs_wholesale_cost", D72),
        ("cs_list_price", D72), ("cs_sales_price", D72),
        ("cs_ext_discount_amt", D72), ("cs_ext_sales_price", D72),
        ("cs_ext_wholesale_cost", D72), ("cs_ext_list_price", D72),
        ("cs_ext_tax", D72), ("cs_coupon_amt", D72),
        ("cs_ext_ship_cost", D72), ("cs_net_paid", D72),
        ("cs_net_paid_inc_tax", D72), ("cs_net_paid_inc_ship", D72),
        ("cs_net_paid_inc_ship_tax", D72), ("cs_net_profit", D72)],
    "time_dim": [
        ("t_time_sk", T.BIGINT), ("t_time_id", V(16)),
        ("t_time", T.BIGINT), ("t_hour", T.BIGINT),
        ("t_minute", T.BIGINT), ("t_second", T.BIGINT),
        ("t_am_pm", V(2)), ("t_shift", V(20)), ("t_sub_shift", V(20)),
        ("t_meal_time", V(20))],
    "reason": [
        ("r_reason_sk", T.BIGINT), ("r_reason_id", V(16)),
        ("r_reason_desc", V(100))],
    "ship_mode": [
        ("sm_ship_mode_sk", T.BIGINT), ("sm_ship_mode_id", V(16)),
        ("sm_type", V(30)), ("sm_code", V(10)), ("sm_carrier", V(20)),
        ("sm_contract", V(20))],
    "call_center": [
        ("cc_call_center_sk", T.BIGINT), ("cc_call_center_id", V(16)),
        ("cc_rec_start_date", T.DATE), ("cc_rec_end_date", T.DATE),
        ("cc_closed_date_sk", T.BIGINT), ("cc_open_date_sk", T.BIGINT),
        ("cc_name", V(50)), ("cc_class", V(50)),
        ("cc_employees", T.BIGINT), ("cc_sq_ft", T.BIGINT),
        ("cc_hours", V(20)), ("cc_manager", V(40)),
        ("cc_mkt_id", T.BIGINT), ("cc_mkt_class", V(50)),
        ("cc_mkt_desc", V(100)), ("cc_market_manager", V(40)),
        ("cc_division", T.BIGINT), ("cc_division_name", V(50)),
        ("cc_company", T.BIGINT), ("cc_company_name", V(50)),
        ("cc_street_number", V(10)), ("cc_street_name", V(60)),
        ("cc_street_type", V(15)), ("cc_suite_number", V(10)),
        ("cc_city", V(60)), ("cc_county", V(30)), ("cc_state", V(2)),
        ("cc_zip", V(10)), ("cc_country", V(20)),
        ("cc_gmt_offset", D52), ("cc_tax_percentage", D52)],
    "catalog_page": [
        ("cp_catalog_page_sk", T.BIGINT), ("cp_catalog_page_id", V(16)),
        ("cp_start_date_sk", T.BIGINT), ("cp_end_date_sk", T.BIGINT),
        ("cp_department", V(50)), ("cp_catalog_number", T.BIGINT),
        ("cp_catalog_page_number", T.BIGINT), ("cp_description", V(100)),
        ("cp_type", V(100))],
    "web_site": [
        ("web_site_sk", T.BIGINT), ("web_site_id", V(16)),
        ("web_rec_start_date", T.DATE), ("web_rec_end_date", T.DATE),
        ("web_name", V(50)), ("web_open_date_sk", T.BIGINT),
        ("web_close_date_sk", T.BIGINT), ("web_class", V(50)),
        ("web_manager", V(40)), ("web_mkt_id", T.BIGINT),
        ("web_mkt_class", V(50)), ("web_mkt_desc", V(100)),
        ("web_market_manager", V(40)), ("web_company_id", T.BIGINT),
        ("web_company_name", V(50)), ("web_street_number", V(10)),
        ("web_street_name", V(60)), ("web_street_type", V(15)),
        ("web_suite_number", V(10)), ("web_city", V(60)),
        ("web_county", V(30)), ("web_state", V(2)), ("web_zip", V(10)),
        ("web_country", V(20)), ("web_gmt_offset", D52),
        ("web_tax_percentage", D52)],
    "web_page": [
        ("wp_web_page_sk", T.BIGINT), ("wp_web_page_id", V(16)),
        ("wp_rec_start_date", T.DATE), ("wp_rec_end_date", T.DATE),
        ("wp_creation_date_sk", T.BIGINT), ("wp_access_date_sk", T.BIGINT),
        ("wp_autogen_flag", V(1)), ("wp_customer_sk", T.BIGINT),
        ("wp_url", V(100)), ("wp_type", V(50)),
        ("wp_char_count", T.BIGINT), ("wp_link_count", T.BIGINT),
        ("wp_image_count", T.BIGINT), ("wp_max_ad_count", T.BIGINT)],
    "web_sales": [
        ("ws_sold_date_sk", T.BIGINT), ("ws_sold_time_sk", T.BIGINT),
        ("ws_ship_date_sk", T.BIGINT), ("ws_item_sk", T.BIGINT),
        ("ws_bill_customer_sk", T.BIGINT), ("ws_bill_cdemo_sk", T.BIGINT),
        ("ws_bill_hdemo_sk", T.BIGINT), ("ws_bill_addr_sk", T.BIGINT),
        ("ws_ship_customer_sk", T.BIGINT), ("ws_ship_cdemo_sk", T.BIGINT),
        ("ws_ship_hdemo_sk", T.BIGINT), ("ws_ship_addr_sk", T.BIGINT),
        ("ws_web_page_sk", T.BIGINT), ("ws_web_site_sk", T.BIGINT),
        ("ws_ship_mode_sk", T.BIGINT), ("ws_warehouse_sk", T.BIGINT),
        ("ws_promo_sk", T.BIGINT), ("ws_order_number", T.BIGINT),
        ("ws_quantity", T.BIGINT), ("ws_wholesale_cost", D72),
        ("ws_list_price", D72), ("ws_sales_price", D72),
        ("ws_ext_discount_amt", D72), ("ws_ext_sales_price", D72),
        ("ws_ext_wholesale_cost", D72), ("ws_ext_list_price", D72),
        ("ws_ext_tax", D72), ("ws_coupon_amt", D72),
        ("ws_ext_ship_cost", D72), ("ws_net_paid", D72),
        ("ws_net_paid_inc_tax", D72), ("ws_net_paid_inc_ship", D72),
        ("ws_net_paid_inc_ship_tax", D72), ("ws_net_profit", D72)],
    "web_returns": [
        ("wr_returned_date_sk", T.BIGINT),
        ("wr_returned_time_sk", T.BIGINT), ("wr_item_sk", T.BIGINT),
        ("wr_refunded_customer_sk", T.BIGINT),
        ("wr_refunded_cdemo_sk", T.BIGINT),
        ("wr_refunded_hdemo_sk", T.BIGINT),
        ("wr_refunded_addr_sk", T.BIGINT),
        ("wr_returning_customer_sk", T.BIGINT),
        ("wr_returning_cdemo_sk", T.BIGINT),
        ("wr_returning_hdemo_sk", T.BIGINT),
        ("wr_returning_addr_sk", T.BIGINT),
        ("wr_web_page_sk", T.BIGINT), ("wr_reason_sk", T.BIGINT),
        ("wr_order_number", T.BIGINT), ("wr_return_quantity", T.BIGINT),
        ("wr_return_amt", D72), ("wr_return_tax", D72),
        ("wr_return_amt_inc_tax", D72), ("wr_fee", D72),
        ("wr_return_ship_cost", D72), ("wr_refunded_cash", D72),
        ("wr_reversed_charge", D72), ("wr_account_credit", D72),
        ("wr_net_loss", D72)],
    "catalog_returns": [
        ("cr_returned_date_sk", T.BIGINT),
        ("cr_returned_time_sk", T.BIGINT), ("cr_item_sk", T.BIGINT),
        ("cr_refunded_customer_sk", T.BIGINT),
        ("cr_refunded_cdemo_sk", T.BIGINT),
        ("cr_refunded_hdemo_sk", T.BIGINT),
        ("cr_refunded_addr_sk", T.BIGINT),
        ("cr_returning_customer_sk", T.BIGINT),
        ("cr_returning_cdemo_sk", T.BIGINT),
        ("cr_returning_hdemo_sk", T.BIGINT),
        ("cr_returning_addr_sk", T.BIGINT),
        ("cr_call_center_sk", T.BIGINT),
        ("cr_catalog_page_sk", T.BIGINT), ("cr_ship_mode_sk", T.BIGINT),
        ("cr_warehouse_sk", T.BIGINT), ("cr_reason_sk", T.BIGINT),
        ("cr_order_number", T.BIGINT), ("cr_return_quantity", T.BIGINT),
        ("cr_return_amount", D72), ("cr_return_tax", D72),
        ("cr_return_amt_inc_tax", D72), ("cr_fee", D72),
        ("cr_return_ship_cost", D72), ("cr_refunded_cash", D72),
        ("cr_reversed_charge", D72), ("cr_store_credit", D72),
        ("cr_net_loss", D72)],
}


def _pick(rows, tag, values):
    """(codes, pool) fast path for a word-list column."""
    return (hmod(rows, tag, len(values)), values)


def _yn(rows, tag, yes_pct=50):
    return (np.where(hmod(rows, tag, 100) < yes_pct, 0, 1), ["Y", "N"])


def _words(rows, tag, n=2):
    picks = [hmod(rows, f"{tag}.{i}", len(_TEXT_WORDS)) for i in range(n)]
    w = np.asarray(_TEXT_WORDS, dtype=object)
    cols = [w[p] for p in picks]
    return [" ".join(c[i] for c in cols) for i in range(len(rows))]


def _civil(days: np.ndarray):
    d64 = (np.asarray(days, dtype="int64")).astype("M8[D]")
    y = d64.astype("M8[Y]").astype(np.int64) + 1970
    m = (d64.astype("M8[M]") - d64.astype("M8[Y]")).astype(np.int64) + 1
    dom = (d64 - d64.astype("M8[M]")).astype(np.int64) + 1
    return y, m, dom


def _week_seq(days: np.ndarray) -> np.ndarray:
    # 1998-01-01 is a Thursday; align week boundaries to Monday
    return (days - _DS_START + 3) // 7 + _WEEK_SEQ0


class _DsTable:
    def __init__(self, conn: "TpcdsConnector", name: str):
        self.conn = conn
        self.name = name
        self.columns = _TABLE_COLUMNS[name]
        self.dicts: Dict[str, Dictionary] = {}
        for cname, ctype in self.columns:
            if ctype.is_string:
                self.dicts[cname] = Dictionary()

    def row_count(self, sf: float) -> int:
        return _counts(sf)[self.name]

    def generate(self, sf: float, start: int, end: int,
                 columns: Sequence[str]) -> Page:
        rows = np.arange(start, end, dtype=np.int64)
        gen = getattr(self, f"_gen_{self.name}")
        data = gen(sf, rows, set(columns))
        blocks = []
        for cname in columns:
            ctype = dict(self.columns)[cname]
            vals = data[cname]
            nulls = None
            if isinstance(vals, tuple) and len(vals) == 2 \
                    and isinstance(vals[1], np.ndarray) \
                    and vals[1].dtype == bool:
                vals, nulls = vals  # (values, null_mask)
            if ctype.is_string:
                d = self.dicts[cname]
                if isinstance(vals, tuple):
                    codes_in, pool = vals
                    remap = d.encode(pool)
                    codes = remap[np.asarray(codes_in, dtype=np.int64)]
                else:
                    codes = d.encode(vals)
                blocks.append(Block(ctype, codes.astype(np.int32), nulls, d))
            else:
                blocks.append(Block(
                    ctype, np.asarray(vals, dtype=ctype.storage), nulls))
        n = len(blocks[0]) if blocks else end - start
        return Page(blocks, n)

    # -- dimensions ----------------------------------------------------

    def _gen_date_dim(self, sf, rows, cols):
        days = _DS_START + rows
        y, m, dom = _civil(days)
        dow = (days + 3) % 7  # Mon=0 .. Sun=6
        q = (m - 1) // 3 + 1
        out = {}
        out["d_date_sk"] = _SK0 + rows
        out["d_date_id"] = [f"AAAAAAAA{_SK0 + r:08d}" for r in rows]
        out["d_date"] = days.astype(np.int32)
        out["d_month_seq"] = (y - 1998) * 12 + m - 1 + 1176
        out["d_week_seq"] = _week_seq(days)
        out["d_quarter_seq"] = (y - 1998) * 4 + q - 1 + 392
        out["d_year"] = y
        out["d_dow"] = dow
        out["d_moy"] = m
        out["d_dom"] = dom
        out["d_qoy"] = q
        out["d_fy_year"] = y
        out["d_fy_quarter_seq"] = out["d_quarter_seq"]
        out["d_fy_week_seq"] = out["d_week_seq"]
        out["d_day_name"] = (dow, DAY_NAMES)
        out["d_quarter_name"] = [f"{yy}Q{qq}" for yy, qq in zip(y, q)]
        out["d_holiday"] = (np.where((m == 12) & (dom == 25), 0, 1),
                            ["Y", "N"])
        out["d_weekend"] = (np.where(dow >= 5, 0, 1), ["Y", "N"])
        out["d_following_holiday"] = (np.where((m == 12) & (dom == 26),
                                               0, 1), ["Y", "N"])
        first = days - (dom - 1)
        out["d_first_dom"] = _SK0 + (first - _DS_START)
        out["d_last_dom"] = out["d_first_dom"] + 27
        out["d_same_day_ly"] = _SK0 + rows - 365
        out["d_same_day_lq"] = _SK0 + rows - 91
        n = ["N"] * len(rows)
        for c in ("d_current_day", "d_current_week", "d_current_month",
                  "d_current_quarter", "d_current_year"):
            out[c] = list(n)
        return out

    def _gen_income_band(self, sf, rows, cols):
        k = rows + 1
        return {"ib_income_band_sk": k,
                "ib_lower_bound": (k - 1) * 10_000,
                "ib_upper_bound": k * 10_000}

    def _gen_item(self, sf, rows, cols):
        k = rows + 1
        out = {}
        out["i_item_sk"] = k
        out["i_item_id"] = [f"AAAAAAAA{v:08d}" for v in k]
        start = _DS_START + hmod(rows, "i.rec", 365)
        out["i_rec_start_date"] = start.astype(np.int32)
        end_null = hmod(rows, "i.recend.null", 2) == 0
        out["i_rec_end_date"] = ((start + 730).astype(np.int32), end_null)
        out["i_item_desc"] = _comment(rows, "i.desc", 12)
        # price biased to [55, 85): keeps q64's BETWEEN window populated
        price = 5_500 + hmod(rows, "i.price", 3_000)  # cents
        out["i_current_price"] = price
        out["i_wholesale_cost"] = (price * 6) // 10
        brand = hmod(rows, "i.brand", 10) + 1
        cat = hmod(rows, "i.cat", len(CATEGORIES))
        cls = hmod(rows, "i.class", len(CLASSES))
        out["i_brand_id"] = brand * 1_001
        out["i_brand"] = [f"brand#{b}" for b in brand]
        out["i_class_id"] = cls + 1
        out["i_class"] = (cls, CLASSES)
        out["i_category_id"] = cat + 1
        out["i_category"] = (cat, CATEGORIES)
        man = hmod(rows, "i.man", 100) + 1
        out["i_manufact_id"] = man
        out["i_manufact"] = [f"manufact#{v}" for v in man]
        out["i_size"] = _pick(rows, "i.size", SIZES)
        out["i_formulation"] = [f"{v:014d}" for v in h64(rows, "i.form")
                                % np.uint64(10 ** 14)]
        # a third of items wear a q64 filter color, the rest uniform
        biased = hmod(rows, "i.colorbias", 3) == 0
        cq = hmod(rows, "i.colorq", len(Q64_COLORS))
        cu = hmod(rows, "i.coloru", len(COLORS))
        qidx = np.asarray([COLORS.index(c) for c in Q64_COLORS])
        out["i_color"] = (np.where(biased, qidx[cq], cu), COLORS)
        out["i_units"] = _pick(rows, "i.units", UNITS)
        out["i_container"] = _pick(rows, "i.cont", CONTAINERS)
        out["i_manager_id"] = hmod(rows, "i.mgr", 100) + 1
        out["i_product_name"] = _words(rows, "i.pname", 3)
        return out

    def _gen_customer_demographics(self, sf, rows, cols):
        k = rows + 1
        out = {}
        out["cd_demo_sk"] = k
        out["cd_gender"] = _pick(rows, "cd.gender", GENDER)
        out["cd_marital_status"] = _pick(rows, "cd.marital", MARITAL)
        out["cd_education_status"] = _pick(rows, "cd.edu", EDUCATION)
        out["cd_purchase_estimate"] = (hmod(rows, "cd.purch", 12) + 1) * 500
        out["cd_credit_rating"] = _pick(rows, "cd.credit", CREDIT_RATING)
        out["cd_dep_count"] = hmod(rows, "cd.dep", 7)
        out["cd_dep_employed_count"] = hmod(rows, "cd.depe", 7)
        out["cd_dep_college_count"] = hmod(rows, "cd.depc", 7)
        return out

    def _gen_household_demographics(self, sf, rows, cols):
        out = {}
        out["hd_demo_sk"] = rows + 1
        out["hd_income_band_sk"] = hmod(rows, "hd.ib", 20) + 1
        out["hd_buy_potential"] = _pick(rows, "hd.buy", BUY_POTENTIAL)
        out["hd_dep_count"] = hmod(rows, "hd.dep", 10)
        out["hd_vehicle_count"] = hmod(rows, "hd.veh", 5)
        return out

    def _gen_customer_address(self, sf, rows, cols):
        k = rows + 1
        out = {}
        out["ca_address_sk"] = k
        out["ca_address_id"] = [f"AAAAAAAA{v:08d}" for v in k]
        out["ca_street_number"] = [str(v) for v in
                                   hmod(rows, "ca.stno", 999) + 1]
        out["ca_street_name"] = _words(rows, "ca.stname", 2)
        out["ca_street_type"] = _pick(rows, "ca.sttype", STREET_TYPES)
        out["ca_suite_number"] = [f"Suite {v}" for v in
                                  hmod(rows, "ca.suite", 99)]
        out["ca_city"] = _words(rows, "ca.city", 1)
        out["ca_county"] = _words(rows, "ca.county", 2)
        out["ca_state"] = _pick(rows, "ca.state", STATES)
        out["ca_zip"] = [f"{v:05d}" for v in hmod(rows, "ca.zip", 99_999)]
        out["ca_country"] = ["United States"] * len(rows)
        out["ca_gmt_offset"] = -(hmod(rows, "ca.gmt", 4) + 5) * 100
        out["ca_location_type"] = _pick(rows, "ca.loc", LOCATION_TYPES)
        return out

    def _gen_customer(self, sf, rows, cols):
        c = _counts(sf)
        k = rows + 1
        out = {}
        out["c_customer_sk"] = k
        out["c_customer_id"] = [f"AAAAAAAA{v:08d}" for v in k]
        out["c_current_cdemo_sk"] = hmod(
            rows, "c.cdemo", c["customer_demographics"]) + 1
        out["c_current_hdemo_sk"] = hmod(
            rows, "c.hdemo", c["household_demographics"]) + 1
        out["c_current_addr_sk"] = hmod(
            rows, "c.addr", c["customer_address"]) + 1
        out["c_first_shipto_date_sk"] = _SK0 + hmod(rows, "c.shipto",
                                                    _DS_DAYS)
        out["c_first_sales_date_sk"] = _SK0 + hmod(rows, "c.firstsale",
                                                   _DS_DAYS)
        out["c_salutation"] = _pick(rows, "c.salut", SALUTATIONS)
        out["c_first_name"] = _words(rows, "c.fname", 1)
        out["c_last_name"] = _words(rows, "c.lname", 1)
        out["c_preferred_cust_flag"] = _yn(rows, "c.pref")
        out["c_birth_day"] = hmod(rows, "c.bday", 28) + 1
        out["c_birth_month"] = hmod(rows, "c.bmon", 12) + 1
        out["c_birth_year"] = 1930 + hmod(rows, "c.byear", 63)
        out["c_birth_country"] = _words(rows, "c.bcountry", 1)
        out["c_login"] = [f"user{v}" for v in k]
        out["c_email_address"] = [f"user{v}@example.com" for v in k]
        out["c_last_review_date_sk"] = _SK0 + hmod(rows, "c.review",
                                                   _DS_DAYS)
        return out

    def _gen_promotion(self, sf, rows, cols):
        c = _counts(sf)
        k = rows + 1
        start = hmod(rows, "p.start", _DS_DAYS - 120)
        out = {}
        out["p_promo_sk"] = k
        out["p_promo_id"] = [f"AAAAAAAA{v:08d}" for v in k]
        out["p_start_date_sk"] = _SK0 + start
        out["p_end_date_sk"] = _SK0 + start + 30 + hmod(rows, "p.len", 90)
        out["p_item_sk"] = hmod(rows, "p.item", c["item"]) + 1
        out["p_cost"] = (hmod(rows, "p.cost", 900) + 100) * 100
        out["p_response_target"] = np.ones(len(rows), dtype=np.int64)
        out["p_promo_name"] = _words(rows, "p.name", 2)
        for ch in ("dmail", "email", "catalog", "tv", "radio", "press",
                   "event", "demo"):
            out[f"p_channel_{ch}"] = _yn(rows, f"p.ch.{ch}")
        out["p_channel_details"] = _comment(rows, "p.details", 8)
        out["p_purpose"] = ["Unknown"] * len(rows)
        out["p_discount_active"] = _yn(rows, "p.disc", 30)
        return out

    def _gen_store(self, sf, rows, cols):
        k = rows + 1
        out = {}
        out["s_store_sk"] = k
        out["s_store_id"] = [f"AAAAAAAA{v:08d}" for v in k]
        out["s_rec_start_date"] = np.full(len(rows), _DS_START,
                                          dtype=np.int32)
        end_null = np.ones(len(rows), dtype=bool)
        out["s_rec_end_date"] = (np.zeros(len(rows), dtype=np.int32),
                                 end_null)
        out["s_closed_date_sk"] = (np.zeros(len(rows), dtype=np.int64),
                                   np.ones(len(rows), dtype=bool))
        out["s_store_name"] = _words(rows, "s.name", 1)
        out["s_number_employees"] = 200 + hmod(rows, "s.emp", 100)
        out["s_floor_space"] = 5_000_000 + hmod(rows, "s.floor", 5_000_000)
        out["s_hours"] = _pick(rows, "s.hours", HOURS)
        out["s_manager"] = _words(rows, "s.mgr", 2)
        out["s_market_id"] = hmod(rows, "s.mktid", 10) + 1
        out["s_geography_class"] = ["Unknown"] * len(rows)
        out["s_market_desc"] = _comment(rows, "s.mktdesc", 8)
        out["s_market_manager"] = _words(rows, "s.mktmgr", 2)
        out["s_division_id"] = np.ones(len(rows), dtype=np.int64)
        out["s_division_name"] = ["Unknown"] * len(rows)
        out["s_company_id"] = np.ones(len(rows), dtype=np.int64)
        out["s_company_name"] = ["Unknown"] * len(rows)
        out["s_street_number"] = [str(v) for v in
                                  hmod(rows, "s.stno", 999) + 1]
        out["s_street_name"] = _words(rows, "s.stname", 2)
        out["s_street_type"] = _pick(rows, "s.sttype", STREET_TYPES)
        out["s_suite_number"] = [f"Suite {v}" for v in
                                 hmod(rows, "s.suite", 99)]
        out["s_city"] = _words(rows, "s.city", 1)
        out["s_county"] = _words(rows, "s.county", 2)
        out["s_state"] = _pick(rows, "s.state", STATES)
        out["s_zip"] = [f"{v:05d}" for v in hmod(rows, "s.zip", 99_999)]
        out["s_country"] = ["United States"] * len(rows)
        out["s_gmt_offset"] = -(hmod(rows, "s.gmt", 4) + 5) * 100
        out["s_tax_precentage"] = hmod(rows, "s.tax", 12)
        return out

    def _gen_warehouse(self, sf, rows, cols):
        k = rows + 1
        out = {}
        out["w_warehouse_sk"] = k
        out["w_warehouse_id"] = [f"AAAAAAAA{v:08d}" for v in k]
        out["w_warehouse_name"] = _words(rows, "w.name", 2)
        out["w_warehouse_sq_ft"] = 50_000 + hmod(rows, "w.sqft", 950_000)
        out["w_street_number"] = [str(v) for v in
                                  hmod(rows, "w.stno", 999) + 1]
        out["w_street_name"] = _words(rows, "w.stname", 2)
        out["w_street_type"] = _pick(rows, "w.sttype", STREET_TYPES)
        out["w_suite_number"] = [f"Suite {v}" for v in
                                 hmod(rows, "w.suite", 99)]
        out["w_city"] = _words(rows, "w.city", 1)
        out["w_county"] = _words(rows, "w.county", 2)
        out["w_state"] = _pick(rows, "w.state", STATES)
        out["w_zip"] = [f"{v:05d}" for v in hmod(rows, "w.zip", 99_999)]
        out["w_country"] = ["United States"] * len(rows)
        out["w_gmt_offset"] = -(hmod(rows, "w.gmt", 4) + 5) * 100
        return out

    def _gen_time_dim(self, sf, rows, cols):
        sec = rows  # one row per second of day
        h = sec // 3600
        out = {}
        out["t_time_sk"] = sec
        out["t_time_id"] = [f"AAAAAAAA{v:08d}" for v in sec]
        out["t_time"] = sec
        out["t_hour"] = h
        out["t_minute"] = (sec // 60) % 60
        out["t_second"] = sec % 60
        out["t_am_pm"] = (np.where(h < 12, 0, 1), ["AM", "PM"])
        out["t_shift"] = (np.where(h < 8, 0, np.where(h < 16, 1, 2)),
                          ["third", "first", "second"])
        out["t_sub_shift"] = (np.where(h < 6, 0, np.where(
            h < 12, 1, np.where(h < 18, 2, 3))),
            ["night", "morning", "afternoon", "evening"])
        out["t_meal_time"] = ((np.where(
            (h >= 6) & (h < 9), 1, np.where(
                (h >= 11) & (h < 14), 2, np.where(
                    (h >= 17) & (h < 20), 3, 0)))),
            ["", "breakfast", "lunch", "dinner"])
        return out

    def _gen_reason(self, sf, rows, cols):
        k = rows + 1
        return {"r_reason_sk": k,
                "r_reason_id": [f"AAAAAAAA{v:08d}" for v in k],
                "r_reason_desc": _words(rows, "r.desc", 3)}

    def _gen_ship_mode(self, sf, rows, cols):
        k = rows + 1
        types = ["EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR", "TWO DAY"]
        carriers = ["UPS", "FEDEX", "AIRBORNE", "USPS", "DHL", "TBS",
                    "ZHOU", "ZOUROS", "MSC", "LATVIAN"]
        out = {}
        out["sm_ship_mode_sk"] = k
        out["sm_ship_mode_id"] = [f"AAAAAAAA{v:08d}" for v in k]
        out["sm_type"] = (rows % len(types), types)
        out["sm_code"] = (rows % 4, ["AIR", "SURFACE", "SEA", "RAIL"])
        out["sm_carrier"] = (rows % len(carriers), carriers)
        out["sm_contract"] = [f"{v:015d}" for v in
                              h64(rows, "sm.contract")
                              % np.uint64(10 ** 15)]
        return out

    def _gen_call_center(self, sf, rows, cols):
        k = rows + 1
        out = {}
        out["cc_call_center_sk"] = k
        out["cc_call_center_id"] = [f"AAAAAAAA{v:08d}" for v in k]
        out["cc_rec_start_date"] = np.full(len(rows), _DS_START,
                                           dtype=np.int32)
        out["cc_rec_end_date"] = (np.zeros(len(rows), dtype=np.int32),
                                  np.ones(len(rows), dtype=bool))
        out["cc_closed_date_sk"] = (np.zeros(len(rows), dtype=np.int64),
                                    np.ones(len(rows), dtype=bool))
        out["cc_open_date_sk"] = _SK0 + hmod(rows, "cc.open", 365)
        out["cc_name"] = [f"call center {v}" for v in k]
        out["cc_class"] = (hmod(rows, "cc.class", 3),
                           ["small", "medium", "large"])
        out["cc_employees"] = 100 + hmod(rows, "cc.emp", 600)
        out["cc_sq_ft"] = 10_000 + hmod(rows, "cc.sqft", 90_000)
        out["cc_hours"] = _pick(rows, "cc.hours", HOURS)
        out["cc_manager"] = _words(rows, "cc.mgr", 2)
        out["cc_mkt_id"] = hmod(rows, "cc.mktid", 6) + 1
        out["cc_mkt_class"] = _comment(rows, "cc.mktclass", 4)
        out["cc_mkt_desc"] = _comment(rows, "cc.mktdesc", 8)
        out["cc_market_manager"] = _words(rows, "cc.mktmgr", 2)
        out["cc_division"] = hmod(rows, "cc.div", 6) + 1
        out["cc_division_name"] = _words(rows, "cc.divname", 1)
        out["cc_company"] = hmod(rows, "cc.co", 6) + 1
        out["cc_company_name"] = _words(rows, "cc.coname", 1)
        out["cc_street_number"] = [str(v) for v in
                                   hmod(rows, "cc.stno", 999) + 1]
        out["cc_street_name"] = _words(rows, "cc.stname", 2)
        out["cc_street_type"] = _pick(rows, "cc.sttype", STREET_TYPES)
        out["cc_suite_number"] = [f"Suite {v}" for v in
                                  hmod(rows, "cc.suite", 99)]
        out["cc_city"] = _words(rows, "cc.city", 1)
        out["cc_county"] = _words(rows, "cc.county", 2)
        out["cc_state"] = _pick(rows, "cc.state", STATES)
        out["cc_zip"] = [f"{v:05d}" for v in hmod(rows, "cc.zip", 99_999)]
        out["cc_country"] = ["United States"] * len(rows)
        out["cc_gmt_offset"] = -(hmod(rows, "cc.gmt", 4) + 5) * 100
        out["cc_tax_percentage"] = hmod(rows, "cc.tax", 12)
        return out

    def _gen_catalog_page(self, sf, rows, cols):
        k = rows + 1
        start = hmod(rows, "cp.start", _DS_DAYS - 90)
        out = {}
        out["cp_catalog_page_sk"] = k
        out["cp_catalog_page_id"] = [f"AAAAAAAA{v:08d}" for v in k]
        out["cp_start_date_sk"] = _SK0 + start
        out["cp_end_date_sk"] = _SK0 + start + 30 + hmod(rows, "cp.len",
                                                         60)
        out["cp_department"] = ["DEPARTMENT"] * len(rows)
        out["cp_catalog_number"] = rows // 100 + 1
        out["cp_catalog_page_number"] = rows % 100 + 1
        out["cp_description"] = _comment(rows, "cp.desc", 8)
        out["cp_type"] = (hmod(rows, "cp.type", 3),
                          ["bi-annual", "quarterly", "monthly"])
        return out

    def _gen_web_site(self, sf, rows, cols):
        k = rows + 1
        out = {}
        out["web_site_sk"] = k
        out["web_site_id"] = [f"AAAAAAAA{v:08d}" for v in k]
        out["web_rec_start_date"] = np.full(len(rows), _DS_START,
                                            dtype=np.int32)
        out["web_rec_end_date"] = (np.zeros(len(rows), dtype=np.int32),
                                   np.ones(len(rows), dtype=bool))
        out["web_name"] = [f"site_{v}" for v in rows % 15]
        out["web_open_date_sk"] = _SK0 + hmod(rows, "web.open", 365)
        out["web_close_date_sk"] = (np.zeros(len(rows), dtype=np.int64),
                                    np.ones(len(rows), dtype=bool))
        out["web_class"] = ["Unknown"] * len(rows)
        out["web_manager"] = _words(rows, "web.mgr", 2)
        out["web_mkt_id"] = hmod(rows, "web.mktid", 6) + 1
        out["web_mkt_class"] = _comment(rows, "web.mktclass", 4)
        out["web_mkt_desc"] = _comment(rows, "web.mktdesc", 8)
        out["web_market_manager"] = _words(rows, "web.mktmgr", 2)
        out["web_company_id"] = hmod(rows, "web.co", 6) + 1
        out["web_company_name"] = (hmod(rows, "web.coname", 6),
                                   ["pri", "able", "ought", "bar",
                                    "cally", "ation"])
        out["web_street_number"] = [str(v) for v in
                                    hmod(rows, "web.stno", 999) + 1]
        out["web_street_name"] = _words(rows, "web.stname", 2)
        out["web_street_type"] = _pick(rows, "web.sttype", STREET_TYPES)
        out["web_suite_number"] = [f"Suite {v}" for v in
                                   hmod(rows, "web.suite", 99)]
        out["web_city"] = _words(rows, "web.city", 1)
        out["web_county"] = _words(rows, "web.county", 2)
        out["web_state"] = _pick(rows, "web.state", STATES)
        out["web_zip"] = [f"{v:05d}" for v in
                          hmod(rows, "web.zip", 99_999)]
        out["web_country"] = ["United States"] * len(rows)
        out["web_gmt_offset"] = -(hmod(rows, "web.gmt", 4) + 5) * 100
        out["web_tax_percentage"] = hmod(rows, "web.tax", 12)
        return out

    def _gen_web_page(self, sf, rows, cols):
        c = _counts(sf)
        k = rows + 1
        out = {}
        out["wp_web_page_sk"] = k
        out["wp_web_page_id"] = [f"AAAAAAAA{v:08d}" for v in k]
        out["wp_rec_start_date"] = np.full(len(rows), _DS_START,
                                           dtype=np.int32)
        out["wp_rec_end_date"] = (np.zeros(len(rows), dtype=np.int32),
                                  np.ones(len(rows), dtype=bool))
        out["wp_creation_date_sk"] = _SK0 + hmod(rows, "wp.create", 365)
        out["wp_access_date_sk"] = _SK0 + 365 + hmod(rows, "wp.access",
                                                     365)
        out["wp_autogen_flag"] = _yn(rows, "wp.autogen")
        out["wp_customer_sk"] = hmod(rows, "wp.cust",
                                     c["customer"]) + 1
        out["wp_url"] = ["http://www.foo.com"] * len(rows)
        out["wp_type"] = (hmod(rows, "wp.type", 7),
                          ["ad", "bio", "dynamic", "feedback",
                           "general", "order", "welcome"])
        out["wp_char_count"] = 100 + hmod(rows, "wp.chars", 8_000)
        out["wp_link_count"] = 2 + hmod(rows, "wp.links", 23)
        out["wp_image_count"] = 1 + hmod(rows, "wp.imgs", 6)
        out["wp_max_ad_count"] = hmod(rows, "wp.ads", 5)
        return out

    def _ws_values(self, sf, rows):
        """web_sales column streams (shared with web_returns)."""
        c = _counts(sf)
        ni = _inv_items(sf)
        out = {}
        sold = hmod(rows, "ws.sold", _SOLD_DAYS)
        out["ws_sold_date_sk"] = _SK0 + sold
        out["ws_sold_time_sk"] = hmod(rows, "ws.time", 86_400)
        ship = np.minimum(sold + 2 + hmod(rows, "ws.shiplag", 58),
                          _DS_DAYS - 1)
        out["ws_ship_date_sk"] = _SK0 + ship
        out["ws_item_sk"] = np.where(
            hmod(rows, "ws.itempick", 4) < 3,
            hmod(rows, "ws.itemA", ni) + 1,
            hmod(rows, "ws.itemB", c["item"]) + 1)
        cust = hmod(rows, "ws.cust", c["customer"]) + 1
        out["ws_bill_customer_sk"] = cust
        out["ws_bill_cdemo_sk"] = hmod(rows, "ws.cdemo",
                                       c["customer_demographics"]) + 1
        out["ws_bill_hdemo_sk"] = hmod(rows, "ws.hdemo",
                                       c["household_demographics"]) + 1
        out["ws_bill_addr_sk"] = hmod(rows, "ws.addr",
                                      c["customer_address"]) + 1
        out["ws_ship_customer_sk"] = cust
        out["ws_ship_cdemo_sk"] = out["ws_bill_cdemo_sk"]
        out["ws_ship_hdemo_sk"] = out["ws_bill_hdemo_sk"]
        out["ws_ship_addr_sk"] = out["ws_bill_addr_sk"]
        out["ws_web_page_sk"] = hmod(rows, "ws.page",
                                     c["web_page"]) + 1
        out["ws_web_site_sk"] = hmod(rows, "ws.site",
                                     c["web_site"]) + 1
        out["ws_ship_mode_sk"] = hmod(rows, "ws.shipmode",
                                      c["ship_mode"]) + 1
        out["ws_warehouse_sk"] = hmod(rows, "ws.wh",
                                      c["warehouse"]) + 1
        promo_null = hmod(rows, "ws.promo.null", 5) == 0
        out["ws_promo_sk"] = (hmod(rows, "ws.promo",
                                   c["promotion"]) + 1, promo_null)
        out["ws_order_number"] = rows // 4 + 1
        qty = hmod(rows, "ws.qty", 100) + 1
        out["ws_quantity"] = qty
        whole = 100 + hmod(rows, "ws.whole", 9_900)
        lst = whole + (whole * (20 + hmod(rows, "ws.markup", 80))) // 100
        disc = hmod(rows, "ws.disc", 30)
        sales = (lst * (100 - disc)) // 100
        out["ws_wholesale_cost"] = whole
        out["ws_list_price"] = lst
        out["ws_sales_price"] = sales
        out["ws_ext_discount_amt"] = qty * (lst - sales)
        out["ws_ext_sales_price"] = qty * sales
        out["ws_ext_wholesale_cost"] = qty * whole
        out["ws_ext_list_price"] = qty * lst
        tax = (qty * sales * hmod(rows, "ws.tax", 9)) // 100
        out["ws_ext_tax"] = tax
        coupon = np.where(hmod(rows, "ws.coup", 10) == 0,
                          (qty * sales) // 10, 0)
        out["ws_coupon_amt"] = coupon
        shipc = qty * hmod(rows, "ws.shipc", 1_000)
        out["ws_ext_ship_cost"] = shipc
        net = qty * sales - coupon
        out["ws_net_paid"] = net
        out["ws_net_paid_inc_tax"] = net + tax
        out["ws_net_paid_inc_ship"] = net + shipc
        out["ws_net_paid_inc_ship_tax"] = net + shipc + tax
        out["ws_net_profit"] = net - qty * whole
        return out

    def _gen_web_sales(self, sf, rows, cols):
        return self._ws_values(sf, rows)

    def _gen_web_returns(self, sf, rows, cols):
        parent = rows * 3
        ws = self._ws_values(sf, parent)
        out = {}
        sold = ws["ws_sold_date_sk"] - _SK0
        ret = np.minimum(sold + 1 + hmod(rows, "wr.lag", 60),
                         _DS_DAYS - 1)
        out["wr_returned_date_sk"] = _SK0 + ret
        out["wr_returned_time_sk"] = hmod(rows, "wr.time", 86_400)
        out["wr_item_sk"] = ws["ws_item_sk"]
        out["wr_refunded_customer_sk"] = ws["ws_bill_customer_sk"]
        out["wr_refunded_cdemo_sk"] = ws["ws_bill_cdemo_sk"]
        out["wr_refunded_hdemo_sk"] = ws["ws_bill_hdemo_sk"]
        out["wr_refunded_addr_sk"] = ws["ws_bill_addr_sk"]
        out["wr_returning_customer_sk"] = ws["ws_bill_customer_sk"]
        out["wr_returning_cdemo_sk"] = ws["ws_bill_cdemo_sk"]
        out["wr_returning_hdemo_sk"] = ws["ws_bill_hdemo_sk"]
        out["wr_returning_addr_sk"] = ws["ws_bill_addr_sk"]
        out["wr_web_page_sk"] = ws["ws_web_page_sk"]
        out["wr_reason_sk"] = hmod(rows, "wr.reason", 35) + 1
        out["wr_order_number"] = ws["ws_order_number"]
        rqty = 1 + hmod(rows, "wr.qty", 100) % ws["ws_quantity"]
        out["wr_return_quantity"] = rqty
        amt = rqty * ws["ws_sales_price"]
        out["wr_return_amt"] = amt
        tax = (amt * hmod(rows, "wr.tax", 9)) // 100
        out["wr_return_tax"] = tax
        out["wr_return_amt_inc_tax"] = amt + tax
        out["wr_fee"] = hmod(rows, "wr.fee", 10_000)
        out["wr_return_ship_cost"] = hmod(rows, "wr.shipc", 5_000)
        third = amt // 3
        out["wr_refunded_cash"] = third
        out["wr_reversed_charge"] = third
        out["wr_account_credit"] = amt - 2 * third
        out["wr_net_loss"] = hmod(rows, "wr.loss", 10_000)
        return out

    # -- facts ---------------------------------------------------------

    def _gen_inventory(self, sf, rows, cols):
        c = _counts(sf)
        ni = _inv_items(sf)
        nw = c["warehouse"]
        # row -> (week, warehouse, item): every cell of the lattice, so
        # q72's inventory-by-week join always has its partner row
        week = rows // (ni * nw)
        rem = rows % (ni * nw)
        out = {}
        # Monday of that week (clamped into the covered range)
        day = np.minimum(week * 7 + 4, _DS_DAYS - 1)
        out["inv_date_sk"] = _SK0 + day
        out["inv_item_sk"] = rem % ni + 1
        out["inv_warehouse_sk"] = rem // ni + 1
        out["inv_quantity_on_hand"] = hmod(rows, "inv.qty", 101)
        return out

    def _ss_values(self, sf, rows):
        """store_sales column streams for absolute fact rows (shared with
        store_returns, which re-derives its parent sale's values)."""
        c = _counts(sf)
        ni = _inv_items(sf)
        out = {}
        # store sales concentrate in 1999-2000 (the consecutive-year
        # window q64's self-join pairs up)
        y99 = days_from_civil_host(1999, 1, 1) - _DS_START
        out["ss_sold_date_sk"] = _SK0 + y99 + hmod(rows, "ss.sold", 730)
        out["ss_sold_time_sk"] = hmod(rows, "ss.time", 86_400)
        # bias items toward the inventory-covered prefix
        out["ss_item_sk"] = np.where(
            hmod(rows, "ss.itempick", 2) == 0,
            hmod(rows, "ss.itemA", ni) + 1,
            hmod(rows, "ss.itemB", c["item"]) + 1)
        out["ss_customer_sk"] = hmod(rows, "ss.cust", c["customer"]) + 1
        out["ss_cdemo_sk"] = hmod(rows, "ss.cdemo",
                                  c["customer_demographics"]) + 1
        out["ss_hdemo_sk"] = hmod(rows, "ss.hdemo",
                                  c["household_demographics"]) + 1
        out["ss_addr_sk"] = hmod(rows, "ss.addr",
                                 c["customer_address"]) + 1
        out["ss_store_sk"] = hmod(rows, "ss.store", c["store"]) + 1
        promo_null = hmod(rows, "ss.promo.null", 5) == 0
        out["ss_promo_sk"] = (hmod(rows, "ss.promo",
                                   c["promotion"]) + 1, promo_null)
        out["ss_ticket_number"] = rows // 3 + 1
        qty = hmod(rows, "ss.qty", 100) + 1
        out["ss_quantity"] = qty
        whole = 100 + hmod(rows, "ss.whole", 9_900)       # cents
        lst = whole + (whole * (20 + hmod(rows, "ss.markup", 80))) // 100
        disc = hmod(rows, "ss.disc", 30)                   # percent
        sales = (lst * (100 - disc)) // 100
        out["ss_wholesale_cost"] = whole
        out["ss_list_price"] = lst
        out["ss_sales_price"] = sales
        out["ss_ext_discount_amt"] = qty * (lst - sales)
        out["ss_ext_sales_price"] = qty * sales
        out["ss_ext_wholesale_cost"] = qty * whole
        out["ss_ext_list_price"] = qty * lst
        tax = (qty * sales * hmod(rows, "ss.tax", 9)) // 100
        out["ss_ext_tax"] = tax
        coupon = np.where(hmod(rows, "ss.coup", 10) == 0,
                          (qty * sales) // 10, 0)
        out["ss_coupon_amt"] = coupon
        net = qty * sales - coupon
        out["ss_net_paid"] = net
        out["ss_net_paid_inc_tax"] = net + tax
        out["ss_net_profit"] = net - qty * whole
        return out

    def _gen_store_sales(self, sf, rows, cols):
        return self._ss_values(sf, rows)

    def _gen_store_returns(self, sf, rows, cols):
        parent = rows * 2  # every second sale is returned
        ss = self._ss_values(sf, parent)
        c = _counts(sf)
        out = {}
        sold = ss["ss_sold_date_sk"] - _SK0
        ret = np.minimum(sold + 1 + hmod(rows, "sr.lag", 60), _DS_DAYS - 1)
        out["sr_returned_date_sk"] = _SK0 + ret
        out["sr_return_time_sk"] = hmod(rows, "sr.time", 86_400)
        out["sr_item_sk"] = ss["ss_item_sk"]
        out["sr_customer_sk"] = ss["ss_customer_sk"]
        out["sr_cdemo_sk"] = ss["ss_cdemo_sk"]
        out["sr_hdemo_sk"] = ss["ss_hdemo_sk"]
        out["sr_addr_sk"] = ss["ss_addr_sk"]
        out["sr_store_sk"] = ss["ss_store_sk"]
        out["sr_reason_sk"] = hmod(rows, "sr.reason", 35) + 1
        out["sr_ticket_number"] = ss["ss_ticket_number"]
        rqty = 1 + hmod(rows, "sr.qty", 100) % ss["ss_quantity"]
        out["sr_return_quantity"] = rqty
        amt = rqty * ss["ss_sales_price"]
        out["sr_return_amt"] = amt
        tax = (amt * hmod(rows, "sr.tax", 9)) // 100
        out["sr_return_tax"] = tax
        out["sr_return_amt_inc_tax"] = amt + tax
        out["sr_fee"] = hmod(rows, "sr.fee", 10_000)
        out["sr_return_ship_cost"] = hmod(rows, "sr.shipc", 5_000)
        third = amt // 3
        out["sr_refunded_cash"] = third
        out["sr_reversed_charge"] = third
        out["sr_store_credit"] = amt - 2 * third
        out["sr_net_loss"] = hmod(rows, "sr.loss", 10_000)
        return out

    def _cs_values(self, sf, rows):
        c = _counts(sf)
        ni = _inv_items(sf)
        out = {}
        # a quarter of catalog orders are REPURCHASES: they reuse the
        # (customer, item) of a returned store sale and sell 1-3 months
        # after it, so the cross-channel chain queries (q25/q29:
        # sale -> return -> catalog re-purchase) find join partners
        echo = hmod(rows, "cs.echo", 4) == 0
        ss_parent = (rows % np.int64(max(c["store_sales"] // 2, 1))) * 2
        y99 = days_from_civil_host(1999, 1, 1) - _DS_START
        parent_sold = y99 + hmod(ss_parent, "ss.sold", 730)
        echo_sold = np.minimum(parent_sold + 30 + hmod(rows, "cs.relag",
                                                       60),
                               _SOLD_DAYS - 1)
        sold = np.where(echo, echo_sold,
                        hmod(rows, "cs.sold", _SOLD_DAYS))
        out["cs_sold_date_sk"] = _SK0 + sold
        out["cs_sold_time_sk"] = hmod(rows, "cs.time", 86_400)
        ship = np.minimum(sold + 2 + hmod(rows, "cs.shiplag", 58),
                          _DS_DAYS - 1)
        out["cs_ship_date_sk"] = _SK0 + ship
        echo_cust = hmod(ss_parent, "ss.cust", c["customer"]) + 1
        cust = np.where(echo, echo_cust,
                        hmod(rows, "cs.cust", c["customer"]) + 1)
        out["cs_bill_customer_sk"] = cust
        out["cs_bill_cdemo_sk"] = hmod(rows, "cs.cdemo",
                                       c["customer_demographics"]) + 1
        out["cs_bill_hdemo_sk"] = hmod(rows, "cs.hdemo",
                                       c["household_demographics"]) + 1
        out["cs_bill_addr_sk"] = hmod(rows, "cs.addr",
                                      c["customer_address"]) + 1
        out["cs_ship_customer_sk"] = cust
        out["cs_ship_cdemo_sk"] = out["cs_bill_cdemo_sk"]
        out["cs_ship_hdemo_sk"] = out["cs_bill_hdemo_sk"]
        out["cs_ship_addr_sk"] = out["cs_bill_addr_sk"]
        out["cs_call_center_sk"] = hmod(rows, "cs.cc",
                                        c["call_center"]) + 1
        out["cs_catalog_page_sk"] = hmod(rows, "cs.page",
                                         c["catalog_page"]) + 1
        out["cs_ship_mode_sk"] = hmod(rows, "cs.shipmode",
                                      c["ship_mode"]) + 1
        out["cs_warehouse_sk"] = hmod(rows, "cs.wh", c["warehouse"]) + 1
        # bias toward inventory-covered items (q72 joins inventory);
        # repurchase rows reuse the parent store sale's item
        echo_item = np.where(
            hmod(ss_parent, "ss.itempick", 2) == 0,
            hmod(ss_parent, "ss.itemA", ni) + 1,
            hmod(ss_parent, "ss.itemB", c["item"]) + 1)
        out["cs_item_sk"] = np.where(
            echo, echo_item, np.where(
                hmod(rows, "cs.itempick", 4) < 3,
                hmod(rows, "cs.itemA", ni) + 1,
                hmod(rows, "cs.itemB", c["item"]) + 1))
        promo_null = hmod(rows, "cs.promo.null", 5) == 0
        out["cs_promo_sk"] = (hmod(rows, "cs.promo",
                                   c["promotion"]) + 1, promo_null)
        out["cs_order_number"] = rows // 4 + 1
        qty = hmod(rows, "cs.qty", 100) + 1
        out["cs_quantity"] = qty
        whole = 100 + hmod(rows, "cs.whole", 9_900)
        lst = whole + (whole * (20 + hmod(rows, "cs.markup", 80))) // 100
        disc = hmod(rows, "cs.disc", 30)
        sales = (lst * (100 - disc)) // 100
        out["cs_wholesale_cost"] = whole
        out["cs_list_price"] = lst
        out["cs_sales_price"] = sales
        out["cs_ext_discount_amt"] = qty * (lst - sales)
        out["cs_ext_sales_price"] = qty * sales
        out["cs_ext_wholesale_cost"] = qty * whole
        out["cs_ext_list_price"] = qty * lst
        tax = (qty * sales * hmod(rows, "cs.tax", 9)) // 100
        out["cs_ext_tax"] = tax
        coupon = np.where(hmod(rows, "cs.coup", 10) == 0,
                          (qty * sales) // 10, 0)
        out["cs_coupon_amt"] = coupon
        shipc = qty * hmod(rows, "cs.shipc", 1_000)
        out["cs_ext_ship_cost"] = shipc
        net = qty * sales - coupon
        out["cs_net_paid"] = net
        out["cs_net_paid_inc_tax"] = net + tax
        out["cs_net_paid_inc_ship"] = net + shipc
        out["cs_net_paid_inc_ship_tax"] = net + shipc + tax
        out["cs_net_profit"] = net - qty * whole
        return out

    def _gen_catalog_sales(self, sf, rows, cols):
        return self._cs_values(sf, rows)

    def _gen_catalog_returns(self, sf, rows, cols):
        parent = rows * 3
        cs = self._cs_values(sf, parent)
        out = {}
        sold = cs["cs_sold_date_sk"] - _SK0
        ret = np.minimum(sold + 1 + hmod(rows, "cr.lag", 60), _DS_DAYS - 1)
        out["cr_returned_date_sk"] = _SK0 + ret
        out["cr_returned_time_sk"] = hmod(rows, "cr.time", 86_400)
        out["cr_item_sk"] = cs["cs_item_sk"]
        out["cr_refunded_customer_sk"] = cs["cs_bill_customer_sk"]
        out["cr_refunded_cdemo_sk"] = cs["cs_bill_cdemo_sk"]
        out["cr_refunded_hdemo_sk"] = cs["cs_bill_hdemo_sk"]
        out["cr_refunded_addr_sk"] = cs["cs_bill_addr_sk"]
        out["cr_returning_customer_sk"] = cs["cs_bill_customer_sk"]
        out["cr_returning_cdemo_sk"] = cs["cs_bill_cdemo_sk"]
        out["cr_returning_hdemo_sk"] = cs["cs_bill_hdemo_sk"]
        out["cr_returning_addr_sk"] = cs["cs_bill_addr_sk"]
        out["cr_call_center_sk"] = cs["cs_call_center_sk"]
        out["cr_catalog_page_sk"] = cs["cs_catalog_page_sk"]
        out["cr_ship_mode_sk"] = cs["cs_ship_mode_sk"]
        out["cr_warehouse_sk"] = cs["cs_warehouse_sk"]
        out["cr_reason_sk"] = hmod(rows, "cr.reason", 35) + 1
        out["cr_order_number"] = cs["cs_order_number"]
        rqty = 1 + hmod(rows, "cr.qty", 100) % cs["cs_quantity"]
        out["cr_return_quantity"] = rqty
        amt = rqty * cs["cs_sales_price"]
        out["cr_return_amount"] = amt
        tax = (amt * hmod(rows, "cr.tax", 9)) // 100
        out["cr_return_tax"] = tax
        out["cr_return_amt_inc_tax"] = amt + tax
        out["cr_fee"] = hmod(rows, "cr.fee", 10_000)
        out["cr_return_ship_cost"] = hmod(rows, "cr.shipc", 5_000)
        # refund components sum BELOW the sale price so q64's cs_ui
        # HAVING (sale > 2*refund) keeps most items
        sixth = amt // 6
        out["cr_refunded_cash"] = sixth
        out["cr_reversed_charge"] = sixth
        out["cr_store_credit"] = sixth
        out["cr_net_loss"] = hmod(rows, "cr.loss", 10_000)
        return out


class TpcdsPageSource(ConnectorPageSource):
    def __init__(self, table: _DsTable, sf: float, split: ConnectorSplit,
                 columns: Sequence[ColumnHandle], page_rows: int):
        self.table = table
        self.sf = sf
        self.columns = [c.name for c in columns]
        self.pos = split.row_start
        self.end = split.row_end
        self.page_rows = page_rows
        from .spi import constrained_gen_columns

        self.constraint = split.table.constraint
        self.gen_columns = constrained_gen_columns(self.columns,
                                                   self.constraint)

    def get_next_page(self) -> Optional[Page]:
        if self.pos >= self.end:
            return None
        end = min(self.pos + self.page_rows, self.end)
        page = self.table.generate(self.sf, self.pos, end,
                                   self.gen_columns)
        self.pos = end
        if self.constraint is not None:
            from .spi import enforce_constraint_page

            page = enforce_constraint_page(
                page, self.gen_columns, self.constraint,
                project=range(len(self.columns)))
        return page

    def is_finished(self) -> bool:
        return self.pos >= self.end


class TpcdsMetadata(ConnectorMetadata):
    def __init__(self, conn: "TpcdsConnector"):
        self.conn = conn

    def list_schemas(self) -> List[str]:
        return list(_SCHEMAS)

    def list_tables(self, schema: str) -> List[str]:
        return list(_TABLE_COLUMNS)

    def get_table_handle(self, schema, table) -> Optional[TableHandle]:
        if schema in _SCHEMAS and table in _TABLE_COLUMNS:
            return TableHandle(self.conn.catalog_name, schema, table)
        return None

    def apply_filter(self, table: TableHandle, constraint):
        """Full row-level enforcement at generation, like the TPC-H
        connector (reference: ConnectorMetadata.applyFilter)."""
        from .spi import negotiate_constraint

        return negotiate_constraint(
            table, constraint,
            (n for n, _ in _TABLE_COLUMNS[table.table]))

    def get_columns(self, table: TableHandle) -> List[ColumnHandle]:
        return [ColumnHandle(n, t, i) for i, (n, t)
                in enumerate(_TABLE_COLUMNS[table.table])]

    def get_statistics(self, table: TableHandle) -> TableStatistics:
        sf = _SCHEMAS[table.schema]
        rows = _counts(sf)[table.table]
        cols = {}
        for cname, _ in _TABLE_COLUMNS[table.table]:
            if cname.endswith("_sk"):
                cols[cname] = ColumnStatistics(distinct_count=rows * 0.9)
        return TableStatistics(row_count=float(rows), columns=cols)


class TpcdsSplitManager(ConnectorSplitManager):
    def __init__(self, conn: "TpcdsConnector"):
        self.conn = conn

    def get_splits(self, table: TableHandle,
                   desired_splits: int) -> List[ConnectorSplit]:
        sf = _SCHEMAS[table.schema]
        n = _counts(sf)[table.table]
        k = max(1, min(desired_splits, (n + 1023) // 1024))
        bounds = np.linspace(0, n, k + 1).astype(int)
        return [ConnectorSplit(table, i, k, int(bounds[i]),
                               int(bounds[i + 1]))
                for i in range(k) if bounds[i] < bounds[i + 1]]


class TpcdsConnector(Connector):
    name = "tpcds"

    def data_version(self) -> int:
        return 0    # deterministic generator: data never changes

    def __init__(self, catalog_name: str = "tpcds",
                 page_rows: int = 65536):
        self.catalog_name = catalog_name
        self.page_rows = page_rows
        self._tables: Dict[str, _DsTable] = {}

    def table(self, name: str) -> _DsTable:
        t = self._tables.get(name)
        if t is None:
            t = _DsTable(self, name)
            self._tables[name] = t
        return t

    def metadata(self) -> ConnectorMetadata:
        return TpcdsMetadata(self)

    def split_manager(self) -> ConnectorSplitManager:
        return TpcdsSplitManager(self)

    def page_source(self, split: ConnectorSplit,
                    columns: Sequence[ColumnHandle]) -> ConnectorPageSource:
        sf = _SCHEMAS[split.table.schema]
        return TpcdsPageSource(self.table(split.table.table), sf, split,
                               columns, self.page_rows)
