"""TPC-DS benchmark query texts (spec queries, engine dialect).

Reference analog: ``plugin/trino-tpcds`` + the BASELINE.md TPC-DS
q64/q72 configs. Texts derive from the TPC-DS specification templates
(public benchmark constants, like the TPC-H texts in tpch_queries.py)
with the default substitution parameters and date arithmetic written as
INTERVAL (the engine's dialect, as in the reference's own runs).
"""

TPCDS_QUERIES = {
    # q3: brand revenue by year for one manufacturer in November
    3: """
select d_year, i_brand_id, i_brand, sum(ss_ext_sales_price) as sum_agg
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manufact_id = 53
  and d_moy = 11
group by d_year, i_brand_id, i_brand
order by d_year, sum_agg desc, i_brand_id
limit 100
""",
    # q7: average sale metrics per item for one demographic slice
    7: """
select i_item_id,
       avg(ss_quantity) as agg1, avg(ss_list_price) as agg2,
       avg(ss_coupon_amt) as agg3, avg(ss_sales_price) as agg4
from store_sales, customer_demographics, date_dim, item, promotion
where ss_sold_date_sk = d_date_sk
  and ss_item_sk = i_item_sk
  and ss_cdemo_sk = cd_demo_sk
  and ss_promo_sk = p_promo_sk
  and cd_gender = 'M'
  and cd_marital_status = 'S'
  and cd_education_status = 'College'
  and (p_channel_email = 'N' or p_channel_event = 'N')
  and d_year = 2000
group by i_item_id
order by i_item_id
limit 100
""",
    # q19: brand revenue where customer and store zip prefixes differ
    19: """
select i_brand_id as brand_id, i_brand as brand,
       i_manufact_id, i_manufact,
       sum(ss_ext_sales_price) as ext_price
from date_dim, store_sales, item, customer, customer_address, store
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manager_id = 8
  and d_moy = 11
  and d_year = 1999
  and ss_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and substring(ca_zip from 1 for 5) <> substring(s_zip from 1 for 5)
  and ss_store_sk = s_store_sk
group by i_brand_id, i_brand, i_manufact_id, i_manufact
order by ext_price desc, i_brand, i_brand_id, i_manufact_id,
         i_manufact
limit 100
""",
    # q42: category revenue for one manager's items in November
    42: """
select d_year, i_category_id, i_category,
       sum(ss_ext_sales_price) as revenue
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manager_id = 1
  and d_moy = 11
  and d_year = 2000
group by d_year, i_category_id, i_category
order by revenue desc, d_year, i_category_id, i_category
limit 100
""",
    # q55: brand revenue for one manager in one month
    55: """
select i_brand_id as brand_id, i_brand as brand,
       sum(ss_ext_sales_price) as ext_price
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manager_id = 28
  and d_moy = 11
  and d_year = 1999
group by i_brand_id, i_brand
order by ext_price desc, i_brand_id
limit 100
""",
    # q64: cross-channel sales of the same item by the same store in
    # consecutive years (the "cross_sales" self-joined CTE)
    64: """
with cs_ui as (
    select cs_item_sk,
           sum(cs_ext_list_price) as sale,
           sum(cr_refunded_cash + cr_reversed_charge + cr_store_credit)
               as refund
    from catalog_sales, catalog_returns
    where cs_item_sk = cr_item_sk
      and cs_order_number = cr_order_number
    group by cs_item_sk
    having sum(cs_ext_list_price) >
           2 * sum(cr_refunded_cash + cr_reversed_charge + cr_store_credit)),
cross_sales as (
    select i_product_name as product_name, i_item_sk as item_sk,
           s_store_name as store_name, s_zip as store_zip,
           ad1.ca_street_number as b_street_number,
           ad1.ca_street_name as b_street_name,
           ad1.ca_city as b_city, ad1.ca_zip as b_zip,
           ad2.ca_street_number as c_street_number,
           ad2.ca_street_name as c_street_name,
           ad2.ca_city as c_city, ad2.ca_zip as c_zip,
           d1.d_year as syear, d2.d_year as fsyear, d3.d_year as s2year,
           count(*) as cnt,
           sum(ss_wholesale_cost) as s1, sum(ss_list_price) as s2,
           sum(ss_coupon_amt) as s3
    from store_sales, store_returns, cs_ui,
         date_dim d1, date_dim d2, date_dim d3,
         store, customer,
         customer_demographics cd1, customer_demographics cd2,
         promotion,
         household_demographics hd1, household_demographics hd2,
         customer_address ad1, customer_address ad2,
         income_band ib1, income_band ib2, item
    where ss_store_sk = s_store_sk
      and ss_sold_date_sk = d1.d_date_sk
      and ss_customer_sk = c_customer_sk
      and ss_cdemo_sk = cd1.cd_demo_sk
      and ss_hdemo_sk = hd1.hd_demo_sk
      and ss_addr_sk = ad1.ca_address_sk
      and ss_item_sk = i_item_sk
      and ss_item_sk = sr_item_sk
      and ss_ticket_number = sr_ticket_number
      and ss_item_sk = cs_ui.cs_item_sk
      and c_current_cdemo_sk = cd2.cd_demo_sk
      and c_current_hdemo_sk = hd2.hd_demo_sk
      and c_current_addr_sk = ad2.ca_address_sk
      and c_first_sales_date_sk = d2.d_date_sk
      and c_first_shipto_date_sk = d3.d_date_sk
      and ss_promo_sk = p_promo_sk
      and hd1.hd_income_band_sk = ib1.ib_income_band_sk
      and hd2.hd_income_band_sk = ib2.ib_income_band_sk
      and cd1.cd_marital_status <> cd2.cd_marital_status
      and i_color in ('purple', 'burlywood', 'indian', 'spring',
                      'floral', 'medium')
      and i_current_price between 64 and 64 + 10
      and i_current_price between 64 + 1 and 64 + 15
    group by i_product_name, i_item_sk, s_store_name, s_zip,
             ad1.ca_street_number, ad1.ca_street_name, ad1.ca_city,
             ad1.ca_zip, ad2.ca_street_number, ad2.ca_street_name,
             ad2.ca_city, ad2.ca_zip, d1.d_year, d2.d_year, d3.d_year)
select cs1.product_name, cs1.store_name, cs1.store_zip,
       cs1.b_street_number, cs1.b_street_name, cs1.b_city, cs1.b_zip,
       cs1.c_street_number, cs1.c_street_name, cs1.c_city, cs1.c_zip,
       cs1.syear as syear1, cs1.cnt as cnt1,
       cs1.s1 as s11, cs1.s2 as s21, cs1.s3 as s31,
       cs2.s1 as s12, cs2.s2 as s22, cs2.s3 as s32,
       cs2.syear as syear2, cs2.cnt as cnt2
from cross_sales cs1, cross_sales cs2
where cs1.item_sk = cs2.item_sk
  and cs1.syear = 1999
  and cs2.syear = 1999 + 1
  and cs2.cnt <= cs1.cnt
  and cs1.store_name = cs2.store_name
  and cs1.store_zip = cs2.store_zip
order by cs1.product_name, cs1.store_name, cnt2, s11, s12
""",
    # q72: catalog orders whose warehouse ran short in the order week,
    # split by promotion
    72: """
select i_item_desc, w_warehouse_name, d1.d_week_seq,
       sum(case when p_promo_sk is null then 1 else 0 end) as no_promo,
       sum(case when p_promo_sk is not null then 1 else 0 end) as promo,
       count(*) as total_cnt
from catalog_sales
join inventory on (cs_item_sk = inv_item_sk)
join warehouse on (w_warehouse_sk = inv_warehouse_sk)
join item on (i_item_sk = cs_item_sk)
join customer_demographics on (cs_bill_cdemo_sk = cd_demo_sk)
join household_demographics on (cs_bill_hdemo_sk = hd_demo_sk)
join date_dim d1 on (cs_sold_date_sk = d1.d_date_sk)
join date_dim d2 on (inv_date_sk = d2.d_date_sk)
join date_dim d3 on (cs_ship_date_sk = d3.d_date_sk)
left outer join promotion on (cs_promo_sk = p_promo_sk)
left outer join catalog_returns on (cr_item_sk = cs_item_sk
                                    and cr_order_number = cs_order_number)
where d1.d_week_seq = d2.d_week_seq
  and inv_quantity_on_hand < cs_quantity
  and d3.d_date > d1.d_date + interval '5' day
  and hd_buy_potential = '>10000'
  and d1.d_year = 1999
  and cd_marital_status = 'D'
group by i_item_desc, w_warehouse_name, d1.d_week_seq
order by total_cnt desc, i_item_desc, w_warehouse_name, d1.d_week_seq
limit 100
""",
    # q13: average sale metrics under OR'd demographic/address slices
    13: """
select avg(ss_quantity) a1, avg(ss_ext_sales_price) a2,
       avg(ss_ext_wholesale_cost) a3, sum(ss_ext_wholesale_cost) a4
from store_sales, store, customer_demographics,
     household_demographics, customer_address, date_dim
where s_store_sk = ss_store_sk
  and ss_sold_date_sk = d_date_sk and d_year = 2000
  and ss_hdemo_sk = hd_demo_sk and cd_demo_sk = ss_cdemo_sk
  and ss_addr_sk = ca_address_sk and ca_country = 'United States'
  and ((cd_marital_status = 'M' and cd_education_status = 'College'
        and ss_sales_price between 10.00 and 90.00 and hd_dep_count = 3)
    or (cd_marital_status = 'S' and cd_education_status = 'Primary'
        and ss_sales_price between 20.00 and 120.00 and hd_dep_count = 1)
    or (cd_marital_status = 'W' and cd_education_status = 'Advanced Degree'
        and ss_sales_price between 30.00 and 150.00 and hd_dep_count = 1))
  and ((ca_state in ('TX', 'OH', 'TX')
        and ss_net_profit between -2000 and 3000)
    or (ca_state in ('OR', 'NM', 'KY')
        and ss_net_profit between -2000 and 3000)
    or (ca_state in ('VA', 'TX', 'MS')
        and ss_net_profit between -2000 and 3000))
""",
    # q15: catalog sales by customer zip for one quarter
    15: """
select ca_zip, sum(cs_sales_price) total
from catalog_sales, customer, customer_address, date_dim
where cs_bill_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and (substring(ca_zip from 1 for 5) in
       ('85669', '86197', '88274', '83405', '86475',
        '85392', '85460', '80348', '81792')
       or ca_state in ('CA', 'WA', 'GA')
       or cs_sales_price > 160)
  and cs_sold_date_sk = d_date_sk
  and d_qoy = 2 and d_year = 2000
group by ca_zip
order by ca_zip
limit 100
""",
    # q21: inventory before/after a cutoff date per warehouse/item
    21: """
select w_warehouse_name, i_item_id,
       sum(case when d_date < date '2000-03-11'
                then inv_quantity_on_hand else 0 end) as inv_before,
       sum(case when d_date >= date '2000-03-11'
                then inv_quantity_on_hand else 0 end) as inv_after
from inventory, warehouse, item, date_dim
where i_item_sk = inv_item_sk
  and inv_warehouse_sk = w_warehouse_sk
  and inv_date_sk = d_date_sk
  and i_current_price between 55 and 85
  and d_date between date '2000-02-10' and date '2000-04-10'
group by w_warehouse_name, i_item_id
order by w_warehouse_name, i_item_id
limit 100
""",
    # q25: store sale -> store return -> catalog re-purchase profit chain
    25: """
select i_item_id, i_item_desc, s_store_id, s_store_name,
       sum(ss_net_profit) as store_sales_profit,
       sum(sr_net_loss) as store_returns_loss,
       sum(cs_net_profit) as catalog_sales_profit
from store_sales, store_returns, catalog_sales, date_dim d1,
     date_dim d2, date_dim d3, store, item
where d1.d_moy = 4 and d1.d_year = 2000
  and d1.d_date_sk = ss_sold_date_sk
  and i_item_sk = ss_item_sk and s_store_sk = ss_store_sk
  and ss_customer_sk = sr_customer_sk and ss_item_sk = sr_item_sk
  and ss_ticket_number = sr_ticket_number
  and sr_returned_date_sk = d2.d_date_sk
  and d2.d_moy between 4 and 10 and d2.d_year = 2000
  and sr_customer_sk = cs_bill_customer_sk and sr_item_sk = cs_item_sk
  and cs_sold_date_sk = d3.d_date_sk
  and d3.d_moy between 4 and 10 and d3.d_year = 2000
group by i_item_id, i_item_desc, s_store_id, s_store_name
order by i_item_id, i_item_desc, s_store_id, s_store_name
limit 100
""",
    # q26: catalog analog of q7
    26: """
select i_item_id,
       avg(cs_quantity) agg1, avg(cs_list_price) agg2,
       avg(cs_coupon_amt) agg3, avg(cs_sales_price) agg4
from catalog_sales, customer_demographics, date_dim, item, promotion
where cs_sold_date_sk = d_date_sk
  and cs_item_sk = i_item_sk
  and cs_bill_cdemo_sk = cd_demo_sk
  and cs_promo_sk = p_promo_sk
  and cd_gender = 'M'
  and cd_marital_status = 'S'
  and cd_education_status = 'College'
  and (p_channel_email = 'N' or p_channel_event = 'N')
  and d_year = 2000
group by i_item_id
order by i_item_id
limit 100
""",
    # q29: quantity flow store sale -> return -> catalog re-purchase
    29: """
select i_item_id, i_item_desc, s_store_id, s_store_name,
       sum(ss_quantity) as store_sales_quantity,
       sum(sr_return_quantity) as store_returns_quantity,
       sum(cs_quantity) as catalog_sales_quantity
from store_sales, store_returns, catalog_sales, date_dim d1,
     date_dim d2, date_dim d3, store, item
where d1.d_moy = 9 and d1.d_year = 1999
  and d1.d_date_sk = ss_sold_date_sk
  and i_item_sk = ss_item_sk and s_store_sk = ss_store_sk
  and ss_customer_sk = sr_customer_sk and ss_item_sk = sr_item_sk
  and ss_ticket_number = sr_ticket_number
  and sr_returned_date_sk = d2.d_date_sk
  and d2.d_moy between 9 and 12 and d2.d_year = 1999
  and sr_customer_sk = cs_bill_customer_sk and sr_item_sk = cs_item_sk
  and cs_sold_date_sk = d3.d_date_sk
  and d3.d_year in (1999, 2000, 2001)
group by i_item_id, i_item_desc, s_store_id, s_store_name
order by i_item_id, i_item_desc, s_store_id, s_store_name
limit 100
""",
    # q32: excess catalog discount vs 1.3x the item's average
    32: """
select sum(cs_ext_discount_amt) as excess_discount_amount
from catalog_sales, item, date_dim
where i_manufact_id = 77
  and i_item_sk = cs_item_sk
  and d_date between date '2000-01-27' and date '2000-04-26'
  and d_date_sk = cs_sold_date_sk
  and cs_ext_discount_amt >
      (select 1.3 * avg(cs_ext_discount_amt)
       from catalog_sales, date_dim
       where cs_item_sk = i_item_sk
         and d_date between date '2000-01-27' and date '2000-04-26'
         and d_date_sk = cs_sold_date_sk)
""",
    # q37: catalog items in a price band with mid inventory
    37: """
select i_item_id, i_item_desc, i_current_price
from item, inventory, date_dim, catalog_sales
where i_current_price between 60 and 80
  and inv_item_sk = i_item_sk
  and d_date_sk = inv_date_sk
  and d_date between date '2000-02-01' and date '2000-04-01'
  and i_manufact_id in (7, 23, 56, 88)
  and inv_quantity_on_hand between 40 and 100
  and cs_item_sk = i_item_sk
group by i_item_id, i_item_desc, i_current_price
order by i_item_id
limit 100
""",
    # q40: catalog sales value around a cutoff, returns netted out
    40: """
select w_state, i_item_id,
       sum(case when d_date < date '2000-03-11'
                then cs_sales_price - coalesce(cr_refunded_cash, 0)
                else 0 end) as sales_before,
       sum(case when d_date >= date '2000-03-11'
                then cs_sales_price - coalesce(cr_refunded_cash, 0)
                else 0 end) as sales_after
from catalog_sales
     left outer join catalog_returns
       on (cs_order_number = cr_order_number and cs_item_sk = cr_item_sk),
     warehouse, item, date_dim
where i_current_price between 55 and 85
  and i_item_sk = cs_item_sk
  and cs_warehouse_sk = w_warehouse_sk
  and cs_sold_date_sk = d_date_sk
  and d_date between date '2000-02-10' and date '2000-04-10'
group by w_state, i_item_id
order by w_state, i_item_id
limit 100
""",
    # q43: store revenue pivoted by day of week
    43: """
select s_store_name, s_store_id,
       sum(case when d_day_name = 'Sunday'
                then ss_sales_price else null end) sun_sales,
       sum(case when d_day_name = 'Monday'
                then ss_sales_price else null end) mon_sales,
       sum(case when d_day_name = 'Tuesday'
                then ss_sales_price else null end) tue_sales,
       sum(case when d_day_name = 'Wednesday'
                then ss_sales_price else null end) wed_sales,
       sum(case when d_day_name = 'Thursday'
                then ss_sales_price else null end) thu_sales,
       sum(case when d_day_name = 'Friday'
                then ss_sales_price else null end) fri_sales,
       sum(case when d_day_name = 'Saturday'
                then ss_sales_price else null end) sat_sales
from date_dim, store_sales, store
where d_date_sk = ss_sold_date_sk
  and s_store_sk = ss_store_sk
  and s_gmt_offset <= -5
  and d_year = 2000
group by s_store_name, s_store_id
order by s_store_name, s_store_id, sun_sales, mon_sales, tue_sales,
         wed_sales, thu_sales, fri_sales, sat_sales
limit 100
""",
    # q46: weekend coupon/profit per ticket where the buyer has since
    # moved city (5-way fact join feeding a 2-way customer join)
    46: """
select c_last_name, c_first_name, ca_city, bought_city, ss_ticket_number,
       amt, profit
from (select ss_ticket_number, ss_customer_sk, ca_city as bought_city,
             sum(ss_coupon_amt) as amt, sum(ss_net_profit) as profit
      from store_sales, date_dim, store, household_demographics,
           customer_address
      where ss_sold_date_sk = d_date_sk
        and ss_store_sk = s_store_sk
        and ss_hdemo_sk = hd_demo_sk
        and ss_addr_sk = ca_address_sk
        and (household_demographics.hd_dep_count = 4
             or household_demographics.hd_vehicle_count = 3)
        and d_dow in (5, 6)
        and d_year in (1999, 2000, 2001)
        and s_city in ('dolphins', 'silent')
      group by ss_ticket_number, ss_customer_sk, ss_addr_sk, ca_city) dn,
     customer, customer_address current_addr
where ss_customer_sk = c_customer_sk
  and customer.c_current_addr_sk = current_addr.ca_address_sk
  and current_addr.ca_city <> bought_city
order by c_last_name, c_first_name, ca_city, bought_city, ss_ticket_number
limit 100
""",
    # q68: month-start ticket totals for movers (q46's shape with
    # extended price/tax/list aggregates)
    68: """
select c_last_name, c_first_name, ca_city, bought_city, ss_ticket_number,
       extended_price, extended_tax, list_price
from (select ss_ticket_number, ss_customer_sk, ca_city as bought_city,
             sum(ss_ext_sales_price) as extended_price,
             sum(ss_ext_list_price) as list_price,
             sum(ss_ext_tax) as extended_tax
      from store_sales, date_dim, store, household_demographics,
           customer_address
      where ss_sold_date_sk = d_date_sk
        and ss_store_sk = s_store_sk
        and ss_hdemo_sk = hd_demo_sk
        and ss_addr_sk = ca_address_sk
        and d_dom between 1 and 2
        and (household_demographics.hd_dep_count = 4
             or household_demographics.hd_vehicle_count = 3)
        and d_year in (1999, 2000, 2001)
        and s_city in ('dolphins', 'silent')
      group by ss_ticket_number, ss_customer_sk, ss_addr_sk, ca_city) dn,
     customer, customer_address current_addr
where ss_customer_sk = c_customer_sk
  and customer.c_current_addr_sk = current_addr.ca_address_sk
  and current_addr.ca_city <> bought_city
order by c_last_name, ss_ticket_number
limit 100
""",
    # q73: month-start tickets per customer in a buy-potential slice
    # with a dependents-per-vehicle ratio filter
    73: """
select c_last_name, c_first_name, c_salutation, c_preferred_cust_flag,
       ss_ticket_number, cnt
from (select ss_ticket_number, ss_customer_sk, count(*) as cnt
      from store_sales, date_dim, store, household_demographics
      where ss_sold_date_sk = d_date_sk
        and ss_store_sk = s_store_sk
        and ss_hdemo_sk = hd_demo_sk
        and d_dom between 1 and 2
        and (household_demographics.hd_buy_potential = '>10000'
             or household_demographics.hd_buy_potential = 'Unknown')
        and household_demographics.hd_vehicle_count > 0
        and case when household_demographics.hd_vehicle_count > 0
                 then household_demographics.hd_dep_count /
                      household_demographics.hd_vehicle_count
                 else null end > 1
        and d_year in (1999, 2000, 2001)
        and s_county in ('around among', 'pending nag')
      group by ss_ticket_number, ss_customer_sk) dj, customer
where ss_customer_sk = c_customer_sk
  and cnt between 1 and 5
order by cnt desc, c_last_name asc, ss_ticket_number
""",
    # q79: one-weekday coupon/profit per ticket at mid-headcount stores
    79: """
select c_last_name, c_first_name,
       substring(s_city from 1 for 30) as city, ss_ticket_number,
       amt, profit
from (select ss_ticket_number, ss_customer_sk, s_city,
             sum(ss_coupon_amt) as amt, sum(ss_net_profit) as profit
      from store_sales, date_dim, store, household_demographics
      where ss_sold_date_sk = d_date_sk
        and ss_store_sk = s_store_sk
        and ss_hdemo_sk = hd_demo_sk
        and (household_demographics.hd_dep_count = 6
             or household_demographics.hd_vehicle_count > 2)
        and d_dow = 1
        and d_year in (1998, 1999, 2000)
        and s_number_employees between 200 and 295
      group by ss_ticket_number, ss_customer_sk, s_city) ms, customer
where ss_customer_sk = c_customer_sk
order by c_last_name, c_first_name,
         substring(s_city from 1 for 30), profit, ss_ticket_number
limit 100
""",
    # q84: returning customers in one city and income band (6-way
    # dimension chain ending at the store_returns fact)
    84: """
select c_customer_id as customer_id,
       c_last_name as customer_last_name,
       c_first_name as customer_first_name
from customer, customer_address, customer_demographics,
     household_demographics, income_band, store_returns
where ca_city = 'pending'
  and c_current_addr_sk = ca_address_sk
  and ib_lower_bound >= 30000
  and ib_upper_bound <= 30000 + 50000
  and ib_income_band_sk = hd_income_band_sk
  and hd_demo_sk = c_current_hdemo_sk
  and cd_demo_sk = c_current_cdemo_sk
  and sr_cdemo_sk = cd_demo_sk
order by c_customer_id, customer_last_name
limit 100
""",
    # q48: total store quantity under OR'd demographic/address slices
    48: """
select sum(ss_quantity) q
from store_sales, store, customer_demographics,
     customer_address, date_dim
where s_store_sk = ss_store_sk
  and ss_sold_date_sk = d_date_sk and d_year = 2000
  and ((cd_demo_sk = ss_cdemo_sk and cd_marital_status = 'M'
        and cd_education_status = '4 yr Degree'
        and ss_sales_price between 10.00 and 90.00)
    or (cd_demo_sk = ss_cdemo_sk and cd_marital_status = 'D'
        and cd_education_status = '2 yr Degree'
        and ss_sales_price between 20.00 and 120.00)
    or (cd_demo_sk = ss_cdemo_sk and cd_marital_status = 'S'
        and cd_education_status = 'College'
        and ss_sales_price between 30.00 and 160.00))
  and ((ss_addr_sk = ca_address_sk and ca_country = 'United States'
        and ca_state in ('CO', 'OH', 'TX')
        and ss_net_profit between 0 and 2000)
    or (ss_addr_sk = ca_address_sk and ca_country = 'United States'
        and ca_state in ('OR', 'MN', 'KY')
        and ss_net_profit between 150 and 3000)
    or (ss_addr_sk = ca_address_sk and ca_country = 'United States'
        and ca_state in ('VA', 'CA', 'MS')
        and ss_net_profit between 50 and 25000))
""",
    # q50: days-to-return buckets per store
    50: """
select s_store_name, s_company_id, s_street_number, s_street_name,
       s_street_type, s_suite_number, s_city, s_county, s_state, s_zip,
       sum(case when (sr_returned_date_sk - ss_sold_date_sk <= 30)
                then 1 else 0 end) as d30,
       sum(case when (sr_returned_date_sk - ss_sold_date_sk > 30) and
                     (sr_returned_date_sk - ss_sold_date_sk <= 60)
                then 1 else 0 end) as d31_60,
       sum(case when (sr_returned_date_sk - ss_sold_date_sk > 60) and
                     (sr_returned_date_sk - ss_sold_date_sk <= 90)
                then 1 else 0 end) as d61_90,
       sum(case when (sr_returned_date_sk - ss_sold_date_sk > 90) and
                     (sr_returned_date_sk - ss_sold_date_sk <= 120)
                then 1 else 0 end) as d91_120,
       sum(case when (sr_returned_date_sk - ss_sold_date_sk > 120)
                then 1 else 0 end) as dgt120
from store_sales, store_returns, store, date_dim d1, date_dim d2
where d2.d_year = 2000 and d2.d_moy = 8
  and ss_ticket_number = sr_ticket_number
  and ss_item_sk = sr_item_sk
  and ss_sold_date_sk = d1.d_date_sk
  and sr_returned_date_sk = d2.d_date_sk
  and ss_customer_sk = sr_customer_sk
  and ss_store_sk = s_store_sk
group by s_store_name, s_company_id, s_street_number, s_street_name,
         s_street_type, s_suite_number, s_city, s_county, s_state, s_zip
order by s_store_name, s_company_id, s_street_number, s_street_name,
         s_street_type, s_suite_number, s_city, s_county, s_state, s_zip
limit 100
""",
    # q52: brand revenue for one November (q42's brand-level cousin)
    52: """
select d_year, i_brand_id as brand_id, i_brand as brand,
       sum(ss_ext_sales_price) as ext_price
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manager_id = 1
  and d_moy = 11
  and d_year = 2000
group by d_year, i_brand_id, i_brand
order by d_year, ext_price desc, brand_id
limit 100
""",
    # q62: web shipping latency buckets per site/mode/warehouse
    62: """
select substring(w_warehouse_name from 1 for 20) wname, sm_type,
       web_name,
       sum(case when (ws_ship_date_sk - ws_sold_date_sk <= 30)
                then 1 else 0 end) as d30,
       sum(case when (ws_ship_date_sk - ws_sold_date_sk > 30) and
                     (ws_ship_date_sk - ws_sold_date_sk <= 60)
                then 1 else 0 end) as d31_60,
       sum(case when (ws_ship_date_sk - ws_sold_date_sk > 60) and
                     (ws_ship_date_sk - ws_sold_date_sk <= 90)
                then 1 else 0 end) as d61_90,
       sum(case when (ws_ship_date_sk - ws_sold_date_sk > 90) and
                     (ws_ship_date_sk - ws_sold_date_sk <= 120)
                then 1 else 0 end) as d91_120,
       sum(case when (ws_ship_date_sk - ws_sold_date_sk > 120)
                then 1 else 0 end) as dgt120
from web_sales, warehouse, ship_mode, web_site, date_dim
where d_month_seq between 1200 and 1211
  and ws_ship_date_sk = d_date_sk
  and ws_warehouse_sk = w_warehouse_sk
  and ws_ship_mode_sk = sm_ship_mode_sk
  and ws_web_site_sk = web_site_sk
group by substring(w_warehouse_name from 1 for 20), sm_type, web_name
order by wname, sm_type, web_name
limit 100
""",
    # q82: store items in a price band with mid inventory
    82: """
select i_item_id, i_item_desc, i_current_price
from item, inventory, date_dim, store_sales
where i_current_price between 60 and 80
  and inv_item_sk = i_item_sk
  and d_date_sk = inv_date_sk
  and d_date between date '2000-02-01' and date '2000-04-01'
  and i_manufact_id in (9, 31, 57, 93)
  and inv_quantity_on_hand between 40 and 100
  and ss_item_sk = i_item_sk
group by i_item_id, i_item_desc, i_current_price
order by i_item_id
limit 100
""",
    # q88: store traffic in eight half-hour slots (scalar subquery grid)
    88: """
select *
from (select count(*) h8_30_to_9
      from store_sales, household_demographics, time_dim, store
      where ss_sold_time_sk = time_dim.t_time_sk
        and ss_hdemo_sk = household_demographics.hd_demo_sk
        and ss_store_sk = s_store_sk
        and time_dim.t_hour = 8 and time_dim.t_minute >= 30
        and ((household_demographics.hd_dep_count = 4
              and household_demographics.hd_vehicle_count <= 6)
          or (household_demographics.hd_dep_count = 2
              and household_demographics.hd_vehicle_count <= 4)
          or (household_demographics.hd_dep_count = 0
              and household_demographics.hd_vehicle_count <= 2))) s1,
     (select count(*) h9_to_9_30
      from store_sales, household_demographics, time_dim, store
      where ss_sold_time_sk = time_dim.t_time_sk
        and ss_hdemo_sk = household_demographics.hd_demo_sk
        and ss_store_sk = s_store_sk
        and time_dim.t_hour = 9 and time_dim.t_minute < 30
        and ((household_demographics.hd_dep_count = 4
              and household_demographics.hd_vehicle_count <= 6)
          or (household_demographics.hd_dep_count = 2
              and household_demographics.hd_vehicle_count <= 4)
          or (household_demographics.hd_dep_count = 0
              and household_demographics.hd_vehicle_count <= 2))) s2,
     (select count(*) h9_30_to_10
      from store_sales, household_demographics, time_dim, store
      where ss_sold_time_sk = time_dim.t_time_sk
        and ss_hdemo_sk = household_demographics.hd_demo_sk
        and ss_store_sk = s_store_sk
        and time_dim.t_hour = 9 and time_dim.t_minute >= 30
        and ((household_demographics.hd_dep_count = 4
              and household_demographics.hd_vehicle_count <= 6)
          or (household_demographics.hd_dep_count = 2
              and household_demographics.hd_vehicle_count <= 4)
          or (household_demographics.hd_dep_count = 0
              and household_demographics.hd_vehicle_count <= 2))) s3,
     (select count(*) h10_to_10_30
      from store_sales, household_demographics, time_dim, store
      where ss_sold_time_sk = time_dim.t_time_sk
        and ss_hdemo_sk = household_demographics.hd_demo_sk
        and ss_store_sk = s_store_sk
        and time_dim.t_hour = 10 and time_dim.t_minute < 30
        and ((household_demographics.hd_dep_count = 4
              and household_demographics.hd_vehicle_count <= 6)
          or (household_demographics.hd_dep_count = 2
              and household_demographics.hd_vehicle_count <= 4)
          or (household_demographics.hd_dep_count = 0
              and household_demographics.hd_vehicle_count <= 2))) s4
""",
    # q91: call-center catalog-return losses by demographic slice
    91: """
select cc_call_center_id, cc_name, cc_manager,
       sum(cr_net_loss) as returns_loss
from call_center, catalog_returns, date_dim, customer,
     customer_demographics, household_demographics
where cr_call_center_sk = cc_call_center_sk
  and cr_returned_date_sk = d_date_sk
  and cr_returning_customer_sk = c_customer_sk
  and cd_demo_sk = c_current_cdemo_sk
  and hd_demo_sk = c_current_hdemo_sk
  and d_year = 2000
  and cd_marital_status in ('M', 'W')
  and hd_buy_potential like '%0%'
group by cc_call_center_id, cc_name, cc_manager
order by returns_loss desc, cc_call_center_id
""",
    # q92: excess web discount vs 1.3x the item's average
    92: """
select sum(ws_ext_discount_amt) as excess_discount_amount
from web_sales, item, date_dim
where i_manufact_id = 35
  and i_item_sk = ws_item_sk
  and d_date between date '2000-01-27' and date '2000-04-26'
  and d_date_sk = ws_sold_date_sk
  and ws_ext_discount_amt >
      (select 1.3 * avg(ws_ext_discount_amt)
       from web_sales, date_dim
       where ws_item_sk = i_item_sk
         and d_date between date '2000-01-27' and date '2000-04-26'
         and d_date_sk = ws_sold_date_sk)
order by excess_discount_amount
""",
    # q96: store traffic for one half hour + dependent count
    96: """
select count(*) cnt
from store_sales, household_demographics, time_dim, store
where ss_sold_time_sk = time_dim.t_time_sk
  and ss_hdemo_sk = household_demographics.hd_demo_sk
  and ss_store_sk = s_store_sk
  and time_dim.t_hour = 20
  and time_dim.t_minute >= 30
  and household_demographics.hd_dep_count = 7
order by cnt
""",
    # q99: catalog shipping latency buckets per call center/mode
    99: """
select substring(w_warehouse_name from 1 for 20) wname, sm_type,
       cc_name,
       sum(case when (cs_ship_date_sk - cs_sold_date_sk <= 30)
                then 1 else 0 end) as d30,
       sum(case when (cs_ship_date_sk - cs_sold_date_sk > 30) and
                     (cs_ship_date_sk - cs_sold_date_sk <= 60)
                then 1 else 0 end) as d31_60,
       sum(case when (cs_ship_date_sk - cs_sold_date_sk > 60) and
                     (cs_ship_date_sk - cs_sold_date_sk <= 90)
                then 1 else 0 end) as d61_90,
       sum(case when (cs_ship_date_sk - cs_sold_date_sk > 90) and
                     (cs_ship_date_sk - cs_sold_date_sk <= 120)
                then 1 else 0 end) as d91_120,
       sum(case when (cs_ship_date_sk - cs_sold_date_sk > 120)
                then 1 else 0 end) as dgt120
from catalog_sales, warehouse, ship_mode, call_center, date_dim
where d_month_seq between 1200 and 1211
  and cs_ship_date_sk = d_date_sk
  and cs_warehouse_sk = w_warehouse_sk
  and cs_ship_mode_sk = sm_ship_mode_sk
  and cs_call_center_sk = cc_call_center_sk
group by substring(w_warehouse_name from 1 for 20), sm_type, cc_name
order by wname, sm_type, cc_name
limit 100
""",
}
